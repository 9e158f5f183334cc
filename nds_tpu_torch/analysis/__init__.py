"""Static analysis of bound plans (the port of nds_tpu/analysis/):

* `budget` - the static plan budgeter: per-node cardinality bounds and a
  peak device-byte model folded into a plan-time verdict (direct |
  blocked | spill | over | reject | unknown) that annotates blocked-union
  windows and out-of-core partitions, on the card's own budget lines.
* `verifier` - the static schema inference the budgeter sizes rows by.
  The verifier's rules (`engine.verify_plans`) are ROADMAP.md queue 1
  item 9.
"""
