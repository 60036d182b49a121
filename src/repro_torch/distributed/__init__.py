"""Distributed pieces of the port: so far the restart supervisor of
``launch/train.py`` (``fault_tolerance``); the multi-GPU collectives come
later."""
