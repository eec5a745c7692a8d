"""Continuous-batching serving over a slot-granular KV pool — the port of
the JAX package's slot engine: `kv_manager.KVCachePool`,
`scheduler.FIFOScheduler`, `engine.ContinuousBatchingEngine`,
`loadgen` and the `serve` CLI. The paged engine, the SLO scheduler,
speculative decoding and the fleet are not ported yet (ROADMAP.md)."""
