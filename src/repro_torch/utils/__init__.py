"""Accounting for the dry-run: per-rank collectives, FLOPs and memory
(``collectives``) and the roofline terms with H100 data-sheet rates
(``roofline``)."""
