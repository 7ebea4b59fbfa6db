"""The benchmark of the PyTorch and CUDA port: ``python3 portbench/run.py``.

Everything a cell needs is found by name: ``BENCHMARK.json`` at the root of
the checkout lists the cells; ``configs/<config>.json`` holds a deployment,
whose corpus generator is ``corpora/<kind>.py``; ``traffic/<traffic>.json``
holds the parameters of a traffic mix, which names its entry into the port,
``entries/<entry>.py``, and the statistic of each end-to-end metric,
``stats/<stat>.py``; ``metrics/<metric>.py`` is the reader of a per-layer
metric.
"""
