"""Launchers of the port: the mesh (``mesh.py``) and the serving and
training entry points, ``python -m repro_torch.launch.serve`` and
``python -m repro_torch.launch.train`` (counterparts of the JAX package's
``repro.launch``).  They run on the card unless given ``--device cpu``."""
