"""The port's user entry points, the counterparts of ``examples/*.py``.

Each example runs as ``python -m repro_torch.examples.<name>`` and on the
card unless ``--device cpu`` is given; there is no fallback.  Each
exposes ``main(argv=None, *, params=None)``: it parses ``argv`` (the
command line when None) with the reference example's flags plus
``--device``, prints the reference example's lines, and returns what it
printed (``lines``) beside the results behind them.  ``params``, where an
example takes one, replaces the seeded initial model (the port's layout,
e.g. from :mod:`repro_torch.convert`).

- ``quickstart``: one offloading plan, then 4 FL rounds.
- ``offloading_walkthrough``: constellation, coverage windows, handover
  schedule and offloading plan of one round.
- ``sagin_fl_end2end``: adaptive offloading against none over 200
  rounds; scenarios, every region, one global model under a federation
  policy, traces.
- ``multiarch_demo``: a reduced variant of every config: 3 train steps,
  then 4 greedy decode tokens.
- ``serve_demo``: prefill by repeated ``serve_step``, then greedy
  generation.
"""
