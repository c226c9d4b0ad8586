"""The yardstick of the benchmark: everything that decides a number.

Traffic generation (``loadgen``), percentiles (``stats``), the FLOP and
byte counts (``counts``), the profiler arithmetic (``trace``), the
weights drawn from the seed (``weights``), the run of one cell
(``cell``), the recording of the program's own state in the window
(``capture``) and the comparison that decides ``correct`` (``check``).
Nothing here imports ``jax`` or the JAX package; the program under test
(``repro_torch``) is imported only by ``cell`` and ``capture``.
"""
