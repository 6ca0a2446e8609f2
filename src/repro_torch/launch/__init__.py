"""Launchers of the port: the LM serving CLI (`python -m
repro_torch.launch.serve`)."""
