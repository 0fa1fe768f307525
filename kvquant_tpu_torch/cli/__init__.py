"""Command-line entry points of the port (kvquant_tpu.cli's surface; the
same flags and defaults, plus ``--device``):

  python -m kvquant_tpu_torch.cli.generate   long-context generation
  python -m kvquant_tpu_torch.cli.passkey    passkey retrieval
  python -m kvquant_tpu_torch.cli.needle     needle in a haystack
  python -m kvquant_tpu_torch.cli.serve_demo continuous batching (slot or
                                             page pool)

eval_ppl, deploy, calibrate and fisher wait for the simulated path,
calibration and parallelism (ROADMAP queue 1 items 8, 9, 12).
"""
