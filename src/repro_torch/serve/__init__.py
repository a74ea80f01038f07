"""Online serving: hot-row cache, the online server and its request loop
(port of ``repro.serve``; micro-batching and shadow re-tiers come with a
later slice)."""
