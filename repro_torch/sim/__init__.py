"""Discrete-event queue the serving engine runs on (verbatim copy of the
JAX package's ``sim/events.py``)."""
