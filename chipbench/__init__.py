"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one card.

``python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json``. Everything that belongs to one
configuration, traffic mix or per-layer metric is a file of its own, found by
the name the cell gives: ``configs/<config>.json``, ``traffic/<mix>.json``
(which names its driver, ``drivers/<driver>.py``) and ``metrics/<metric>.py``.
The yardstick lives here too: the generators (``gen.py``), the data-sheet
peaks (``peaks.py``), the reduction of a profiler trace (``trace.py``), each
kernel's operation and byte counts (``counts/``) and the plain references that
decide ``correct`` (``reference/``). Nothing here imports JAX or the JAX
package, and ``reference/`` imports nothing of the port.
"""
