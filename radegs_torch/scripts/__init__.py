"""The port's command-line entry points, each runnable as
``python -m radegs_torch.scripts.<name>`` and importable as ``main(argv)``:
``train``, ``render``, ``mesh_extract``, ``mesh_extract_tetrahedra``,
``kernel_bisect``, the evaluation's ``metrics``, ``cull_mesh``,
``eval_tnt``, ``eval_dtu`` and ``evaluate_dtu_mesh``, and the at-schedule
protocols on the closed-form sphere + plane scene (``synthetic``):
``quality_dense``, ``soak_dense`` and ``decimation_sweep``. Those that use
the card run on ``cuda`` unless given ``--device cpu``."""
