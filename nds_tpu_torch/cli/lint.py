"""CLI: `nds-tpu-torch-submit lint` — run the engine lint over
nds_tpu_torch/ (the port of nds_tpu/cli/lint.py).

Exits non-zero on any finding; see nds_tpu_torch/analysis/lint.py for the
rule table and the `# nds-lint: disable=<rule>` pragma syntax.
`--write-lock-order` regenerates anchors/lock_order_torch.golden, the
port's pinned lock order, from the tree.
"""

from __future__ import annotations

import sys

from ..analysis.lint import main

if __name__ == "__main__":
    sys.exit(main())
