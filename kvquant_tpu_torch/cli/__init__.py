"""Command-line entry points of the port (kvquant_tpu.cli's surface; the
same flags and defaults, plus ``--device``):

  python -m kvquant_tpu_torch.cli.generate   long-context generation
  python -m kvquant_tpu_torch.cli.passkey    passkey retrieval
  python -m kvquant_tpu_torch.cli.needle     needle in a haystack

eval_ppl, deploy, calibrate, fisher and serve_demo wait for the simulated
path, calibration, parallelism and serving (ROADMAP queue 1 items 8-12).
"""
