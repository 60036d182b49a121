"""Entry points of the PyTorch port: ``python -m repro_torch.launch.serve``
(counterpart of ``repro.launch.serve``) and ``python -m
repro_torch.launch.train`` (of ``repro.launch.train``); ``launch.mesh``
builds the device meshes (of ``repro.launch.mesh``)."""
