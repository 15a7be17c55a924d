"""The benchmark of ``suffix_torch`` on one NVIDIA H100.

``run.py`` runs one cell of ``BENCHMARK.json`` once. Everything that
belongs to one configuration, traffic mix or metric lives in a file of its
own, found by the name that ``BENCHMARK.json`` gives it:
``configs/<config>.json``, ``traffic/<mix>.json`` (read by the runner it
names, ``runners/<runner>.py``), ``metrics/<metric>.py`` and the corpus
generator a configuration names, ``corpora/<corpus>.py``.
"""
