"""Device meshes of the port (``repro_torch.launch.mesh``)."""
