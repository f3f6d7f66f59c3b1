"""Log fan-out (console, per-app file, master file), the canonical
throughput row, the collective `DATATYPE OP NODES GB/sec` row, the
quantized curve's `DATATYPE OP BITS NODES WIREX MAXERR BOUND` row and the
family's `DATATYPE OP IMPL N GBPS STATUS` row, each byte-identical to the
JAX package's (tpu_reductions/utils/logging.py). The templates and headers
come from the port's lint/grammar.py, which the lint's RED005 holds every
other literal to."""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Optional, TextIO

# the reference's collective rows (reduce.c:67-69), which its getAvgs.sh
# averages (the files bench/aggregate.py reads and writes), the quantized
# curve's rows (bench/quant_curve.py) and the family's rows
# (bench/family_spot.py)
from tpu_reductions_torch.lint.grammar import (  # noqa: F401
    COLLECTIVE_COLUMNS, COLLECTIVE_HEADER, COLLECTIVE_ROW_TEMPLATE,
    FAMILY_COLUMNS, FAMILY_HEADER, FAMILY_ROW_TEMPLATE, QUANT_CURVE_COLUMNS,
    QUANT_CURVE_HEADER, QUANT_CURVE_ROW_TEMPLATE, THROUGHPUT_TEMPLATE)

_ROW_DTYPES = {"int32": "INT", "float64": "DOUBLE", "float32": "FLOAT",
               "bfloat16": "BF16"}


def throughput_line(gbps: float, secs: float, n: int, *,
                    name: str = "Reduction", devices: int = 1,
                    workgroup: int = 256) -> str:
    """`Reduction, Throughput = %.4f GB/s, Time = %.5f s, Size = %u
    Elements, NumDevsUsed = %d, Workgroup = %u`"""
    return THROUGHPUT_TEMPLATE.format(name=name, gbps=gbps, secs=secs, n=n,
                                      devices=devices, workgroup=workgroup)


def collective_row(dtype: str, op: str, ranks: int, gbps: float) -> str:
    """`DATATYPE OP NODES GB/sec`: one rank-0 row of the collective
    benchmark (reduce.c:81,95)."""
    return COLLECTIVE_ROW_TEMPLATE.format(
        dtype=_ROW_DTYPES.get(dtype, dtype.upper()), op=op.upper(),
        ranks=ranks, gbps=gbps)


def quant_curve_row(dtype: str, op: str, bits: int, ranks: int,
                    wirex: float, max_err: float, bound: float) -> str:
    """`DATATYPE OP BITS NODES WIREX MAXERR BOUND`: one row of the
    accuracy-vs-bandwidth curve."""
    return QUANT_CURVE_ROW_TEMPLATE.format(
        dtype=_ROW_DTYPES.get(dtype, dtype.upper()), op=op.upper(),
        bits=bits, ranks=ranks, wirex=wirex, max_err=max_err, bound=bound)


def family_row(dtype: str, op: str, impl: str, n: int, gbps: float,
               status: str) -> str:
    """`DATATYPE OP IMPL N GBPS STATUS`: one family-spot row."""
    return FAMILY_ROW_TEMPLATE.format(
        dtype=_ROW_DTYPES.get(dtype, dtype.upper()), op=op.upper(),
        impl=impl, n=n, gbps=gbps, status=status)


class BenchLogger:
    """`log()` goes to the console and the app file; `log_master()` also
    appends to the master file (the throughput row's destination)."""

    def __init__(self, app_file: Optional[str] = None,
                 master_file: Optional[str] = None,
                 console: Optional[TextIO] = None) -> None:
        self.console = console or sys.stdout
        self._app_path = Path(app_file) if app_file else None
        self._master_path = Path(master_file) if master_file else None
        if self._app_path:
            self._app_path.write_text("")   # truncated on open

    def _append(self, path: Optional[Path], msg: str) -> None:
        if path is not None:
            with path.open("a") as f:
                f.write(msg + "\n")

    def log(self, msg: str) -> None:
        print(msg, file=self.console)
        self.console.flush()
        self._append(self._app_path, msg)

    def log_master(self, msg: str) -> None:
        self.log(msg)
        self._append(self._master_path, msg)
