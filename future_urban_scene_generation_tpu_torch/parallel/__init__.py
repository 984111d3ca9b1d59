from future_urban_scene_generation_tpu_torch.parallel import mesh  # noqa: F401
