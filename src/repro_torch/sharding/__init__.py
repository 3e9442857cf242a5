"""Sharding of the LM substrate over a device mesh — the port of the JAX
package's ``sharding/``: the ambient mesh (``context``) and the rule
tables that give every parameter, optimizer moment, cache and batch tensor
its spec (``specs``)."""
from repro_torch.sharding.specs import (  # noqa: F401
    batch_spec,
    cache_specs,
    param_specs,
    placements,
    state_specs,
)
