"""The flight recorder: the typed JSONL event ledger and its trace context.

The counterpart of tpu_reductions/obs/{ledger,trace}.py. The timeline,
the trace export, the critical path and the compile observatory's store
wait for ROADMAP Queue A item 9 (docs/PORT.md).
"""
