"""Serving — the port of the JAX package's `serving/`: the KV pools
(`kv_manager`), the FIFO and SLO schedulers, the slot engine
`ContinuousBatchingEngine` and the paged engine `PagedEngine` (its pages
cp-sharded at cp > 1) in `engine`, the speculative engine, the dispatch
broadcast of a multi-rank engine (`tp_dispatch`), `loadgen` and the `serve`
CLI; the fleet: the prefix-aware `router`, the KV page stream
(`transfer`), the SLO `controller` and the `serve_fleet` CLI (replicas at
any tp, disaggregated prefill and decode at two widths, a replica
restarted at another width)."""
