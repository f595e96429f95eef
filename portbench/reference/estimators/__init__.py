"""References of the adaptive estimators, one module a ``heatmap_mode``.

A configuration whose ``"pipeline"`` object names ``heatmap_mode`` other
than ``"das"`` (``"mvdr"``, ``"music"``) is checked against
``portbench/reference/estimators/<heatmap_mode>.py``, found by that name
(``portbench.run.load_cell`` stops before set-up where it is missing).
The module defines one function, and may define a second:

    follow(state, blocks, points, cfg, precision) -> (spectrum [D], state)
    comparable(state) -> dict                                   (optional)

- ``state``: the program's estimator state before the sampled call
  (``AwpuPipeline._mvdr_state``, an ``MvdrState`` or ``MusicState``) as
  the NamedTuple's ``_asdict()``: its tensors on the run's device, its
  counters host ints.  They are the program's: read them, write into none;
- ``blocks``: the call's stream blocks [m, C, T] in float64, on the run's
  device;
- ``points``: the element positions [3, C] in metres
  (:func:`portbench.reference.geometry.array_points`);
- ``cfg``: the configuration file as a dict (its ``"pipeline"`` object,
  ``"mimo"`` grid and ``"array"`` among it);
- ``precision``: a name of :mod:`portbench.reference.precision`:
  ``"float64"`` for the reference, the name one below the estimator's
  stated float32 for the control (``portbench.check.ESTIMATOR_PRECISION``).

``follow`` returns the spectrum [D] over the configuration's grid after
the call's last block, as the pipeline renders it in ``heatmap()``, and
the estimator's state after that block as a dict keyed by the program's
NamedTuple fields: its own covariance after the call's blocks, its own
counter, and a carry it rebuilt itself (a refresh block's powers from its
own covariance; between refreshes the carried powers as they were).  It
uses plain ``torch`` (and numpy), imports nothing of the port, and takes
from the program nothing but ``state``: its steering planes, analysis
tables and bin weights it works out again from ``points`` and ``cfg``.

``comparable(state)`` maps an estimator state as a dict, the program's or
the one ``follow`` returned, to what of it is compared; without it, every
entry of the state ``follow`` returned is.  A field whose value is free up
to a transform (MUSIC's signal ``basis``, up to a rotation of its columns)
is compared through what the transform keeps (the projector
``basis @ basis.T``).

``portbench.check`` compares the program's spectrum after the call with
``follow`` at ``"float64"`` (``spectrum_gap``, the largest gap over the
reference's peak), and the program's estimator state after the call with
``follow``'s (``estimator_state_gap``: each tensor's largest gap over its
peak, a counter or a carry that differs reading 1); the control is
``follow`` at the precision below, on both.
"""
