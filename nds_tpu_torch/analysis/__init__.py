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
* `feedback` - the estimate-vs-actual cardinality store
  (`engine.plan_feedback` off | record | on): the budgeter annotates each
  node's key and estimate, the executor records what ran, and mode `on`
  plans from the recorded actuals.
* `lint` - the engine lint (AST rules over nds_tpu_torch/, run by
  `python -m nds_tpu_torch.cli.lint`).
* `concurrency` - the lint's concurrency rules (guarded-by, blocking
  under a lock, thread leaks) and the static lock-order model pinned in
  anchors/lock_order_torch.golden, which engine/lockdebug.py asserts at
  run time.
"""
