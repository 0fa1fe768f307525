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

deploy takes the parallel flags: --tp / --dp with --distributed run this
process as one rank of a torch.distributed group (KVQ_* variables);
without --distributed it starts the dp * tp local ranks itself.
"""
