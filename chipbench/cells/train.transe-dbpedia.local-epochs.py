"""``train.transe-dbpedia.local-epochs``: the epoch kernel's faults."""
from chipbench.cells._shared import _half_batch, _unchanged_step

FAULTS = [_unchanged_step, _half_batch]
CONTROLS = ["half_batch"]
SPAN_METRICS = []
