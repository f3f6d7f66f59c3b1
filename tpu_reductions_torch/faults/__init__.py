"""Deterministic fault injection: `fault_point` and its env-armed plan.

The counterpart of tpu_reductions/faults/inject.py and the schedule
parser of faults/schedule.py. The chaos relay (faults/relay.py) and the
seams other than `exec.launch`, `serve.batch` and `heartbeat.tick` wait
for ROADMAP Queue A item 9 (docs/PORT.md).
"""
