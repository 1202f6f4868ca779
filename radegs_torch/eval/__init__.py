"""Evaluation (port of ``radegs_tpu/eval``): LPIPS on the card (``lpips``),
the DTU chamfer protocol (``dtu``, ``dtu_mesh``) and the Tanks and Temples
F-score protocol (``tnt``), the last three numpy + scipy on the host."""
