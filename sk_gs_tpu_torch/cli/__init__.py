"""The port's entry points, each ``python -m sk_gs_tpu_torch.cli.<name>``:
``train`` (a config to checkpoints and ``results.json``), ``test`` (a
checkpoint to metrics and FPS) and ``render_repose`` (a checkpoint to
posed frames). They run on the card unless given ``--device cpu``."""
