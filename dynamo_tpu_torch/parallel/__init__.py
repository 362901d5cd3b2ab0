"""Tensor parallelism for the port: the mesh of ranks (``mesh.py``) and the
collectives the model calls between them (``collectives.py``)."""
