"""The port's command-line entry points, each runnable as
``python -m radegs_torch.scripts.<name>`` and importable as ``main(argv)``:
``train``, ``render``, ``mesh_extract``, ``mesh_extract_tetrahedra`` and
``kernel_bisect``. They run on ``cuda`` unless given ``--device cpu``."""
