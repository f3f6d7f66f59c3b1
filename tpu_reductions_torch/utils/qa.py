"""QA pass/fail protocol: `&&&& RUNNING/PASSED/FAILED/WAIVED` markers with
exit code = status, byte-identical to the JAX package's. The templates come
from the port's lint/grammar.py, the one definition the lint's RED005
checks every other literal against."""

from __future__ import annotations

import enum
import sys
from typing import Optional

from tpu_reductions_torch.lint.grammar import (QA_FINISH_TEMPLATE,
                                               QA_RUNNING_TEMPLATE)


class QAStatus(enum.IntEnum):
    """Exit statuses; value == process exit code."""

    PASSED = 0
    FAILED = 1
    WAIVED = 2


def qa_start(name: str, argv: Optional[list] = None, *, out=None) -> None:
    """Print the RUNNING marker."""
    out = out or sys.stdout
    args = " ".join(argv) if argv else ""
    print(QA_RUNNING_TEMPLATE.format(name=name, args=args).rstrip(),
          file=out)
    out.flush()


def qa_finish(name: str, status: QAStatus, *, out=None) -> int:
    """Print the terminal marker and return the exit code."""
    out = out or sys.stdout
    print(QA_FINISH_TEMPLATE.format(name=name, status=status.name), file=out)
    out.flush()
    return int(status)
