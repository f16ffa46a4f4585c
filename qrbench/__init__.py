"""The benchmark of ``qrkit_tpu_torch``, the PyTorch and CUDA port.

One run measures one cell (a configuration under a traffic mix) on the
card::

    python3 -m qrbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The harness is driven by data.  ``BENCHMARK.json`` names the cells and the
metrics; everything that belongs to one of them is a file of its own that
the harness finds by that name:

* ``configs/<config>.json``: a configuration (its source, sizes,
  precision, the limits of its correctness check and its reference);
* ``traffic/<mix>.json``: a traffic mix (the caller it feeds, sizes, pool
  and sample counts), read by the one generator, :mod:`qrbench.generate`;
* ``callers/<caller>.py``: the entry a mix drives and its check against the
  plain reference in ``reference/``;
* ``e2e/<metric>.py`` and ``metrics/<metric>.py``: the end-to-end and
  per-layer metrics, each a small reader;
* ``roofline/<kernel>.py``: a kernel's bytes and operations from the
  problem's shapes; ``peaks.json``: the cards' published peaks;
* ``kernels/<kernel>.json``: a kernel's launch counters in the program and
  the names of its profiler records, for the traced run's count of lost
  records.
"""
