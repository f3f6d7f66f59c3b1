"""The greedy value/cost knapsack the serving batcher plans rounds with
(the counterpart of tpu_reductions/sched/knapsack.py). The window
scheduler around it waits for ROADMAP Queue A item 9 (docs/PORT.md).
"""
