"""The program under test, by the name a configuration gives as its
`program`: `programs/<name>.py` holds `setup(config, device)`, which
returns the set-up program (its `solve(b)`, `n`, `host_state()` and
`release()`) and the set-up's phases in seconds."""
