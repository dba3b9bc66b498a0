"""Parallelism on ``torch.distributed``: the rank mesh (``mesh.py``) and
MAG-BERT's tensor parallelism (``tp.py``)."""
