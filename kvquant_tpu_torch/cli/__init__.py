"""Command-line entry points of the port (kvquant_tpu.cli's surface; the
same flags and defaults, plus ``--device``):

  python -m kvquant_tpu_torch.cli.generate   long-context generation
  python -m kvquant_tpu_torch.cli.passkey    passkey retrieval
  python -m kvquant_tpu_torch.cli.needle     needle in a haystack
  python -m kvquant_tpu_torch.cli.serve_demo continuous batching (slot or
                                             page pool)
  python -m kvquant_tpu_torch.cli.calibrate  fit K / V quantizers
  python -m kvquant_tpu_torch.cli.eval_ppl   simulated (and deployed) ppl

deploy and fisher wait for parallelism and Fisher information (ROADMAP
queue 1 items 9 and 12).
"""
