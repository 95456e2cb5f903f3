"""The SPMD layer: sharding rules per family (:mod:`.rules`, the port of
``repro.sharding.rules``) and the DTensor helpers that place and pin
tensors by those rules (:mod:`.spmd`)."""
