"""Logical-axis sharding rules over a ``torch.distributed`` device mesh
(``api.py``) and the serving layouts (``rules.py``)."""
