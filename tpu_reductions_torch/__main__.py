"""`python -m tpu_reductions_torch --method=SUM --type=int ...`"""

import sys

from tpu_reductions_torch.bench.driver import main

if __name__ == "__main__":
    sys.exit(main())
