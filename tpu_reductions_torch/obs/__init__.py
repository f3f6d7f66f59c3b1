"""The flight recorder and its analysis.

The counterpart of tpu_reductions/obs/: the typed JSONL event ledger
(`ledger`) and its trace context (`trace`), host-side spans (`spans`),
the post-mortem timeline (`timeline`), the Chrome trace export
(`trace_export`), the critical path over the span tree
(`critical_path`) and the compile observatory's store and model
(`compile`). A ledger either package writes reads the same through
either package's analysis.
"""
