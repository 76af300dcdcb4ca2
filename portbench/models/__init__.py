"""The builders: one module a family of configurations, named by a
configuration's `"builder"`.  Each holds a `Runner(ctx)` with `setup()`,
`window()`, `end_to_end()`, `counts()`, `release()` and `check()`, and the
values its per-layer metrics read."""
