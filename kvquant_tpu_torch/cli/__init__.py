"""Command-line entry points of the port (kvquant_tpu.cli's surface; the
same flags and defaults, plus ``--device``):

  python -m kvquant_tpu_torch.cli.generate   long-context generation
  python -m kvquant_tpu_torch.cli.passkey    passkey retrieval
  python -m kvquant_tpu_torch.cli.needle     needle in a haystack
  python -m kvquant_tpu_torch.cli.serve_demo continuous batching (slot or
                                             page pool)
  python -m kvquant_tpu_torch.cli.calibrate  fit K / V quantizers
  python -m kvquant_tpu_torch.cli.eval_ppl   simulated (and deployed) ppl
  python -m kvquant_tpu_torch.cli.fisher     Fisher information (npz)
  python -m kvquant_tpu_torch.cli.deploy     cache size, --check, timed
                                             decode, --profile

deploy accepts the parallel flags and runs on one device only
(parallelism is ROADMAP queue 1 item 12).
"""
