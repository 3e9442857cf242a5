"""Operations and bytes each kernel's work needs, counted from its shapes
(each input byte read once, each output byte written once), so that they
read the same work whatever implements it. A module per kernel, named as
the kernel's wrapper counts its launches (``LAUNCHES``), with
``least_seconds(shape, peaks)``: the larger of its bytes at the memory rate
and its instructions at their pipe's rate. Copied from the chip smoke
test's ``score_ops``/``score_bound`` and its sparse-step byte count."""
