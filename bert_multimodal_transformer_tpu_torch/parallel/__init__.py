"""Parallelism on ``torch.distributed``: the rank mesh (``mesh.py``), the
tensor parallelism of MAG-BERT and MAG-XLNet (``tp.py``), FSDP
(``fsdp.py``) and the GPipe pipeline (``pp.py``, ``pp_xlnet.py``)."""
