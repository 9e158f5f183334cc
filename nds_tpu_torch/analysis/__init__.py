"""Static analysis of bound plans (the port of nds_tpu/analysis/):

* `budget` - the static plan budgeter: per-node cardinality bounds and a
  peak device-byte model folded into a plan-time verdict (direct |
  blocked | spill | over | reject | unknown) that annotates blocked-union
  windows and out-of-core partitions, on the card's own budget lines.
* `verifier` - the plan verifier: the static schema inference the
  budgeter sizes rows by, and the rules `engine.verify_plans` runs
  (annotation placement, spill partitions, blocked unions, join-key
  scoping, LEFT->INNER promotion evidence). The mesh's sharding rules
  are ROADMAP.md queue 1 item 13; the Pipeline rules check fusion.
"""
