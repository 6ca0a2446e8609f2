"""Launchers of the port: the LM serving CLI (`python -m
repro_torch.launch.serve`) and the SPDC edge-worker daemon (`python -m
repro_torch.launch.serve_worker`)."""
