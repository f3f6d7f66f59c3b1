"""The window scheduler: value per expected second, planned against the
remaining window, executed task by task, resumed after a death.

The counterpart of tpu_reductions/sched/: `tasks` (the registry of
measurement units, the port's CLIs as commands), `priors` (durations and
the window model learned from ledgers), `planner` (the greedy plan over
the shared `knapsack`, which the serving batcher also ranks with),
`state` (the crash-safe plan state), `executor` (one subprocess a task,
exits 3 and 4 propagated) and the CLI (`python -m
tpu_reductions_torch.sched`).
"""
