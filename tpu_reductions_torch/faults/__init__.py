"""Deterministic fault injection and the chaos relay.

The counterpart of tpu_reductions/faults/: `fault_point` and its
env-armed plan (inject.py), the schedule parser (schedule.py), and the
schedule-driven relay (relay.py), which in the port models a launch's
round trip. The seams the port declares are listed in inject.py.
"""
