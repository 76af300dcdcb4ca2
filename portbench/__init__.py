"""portbench: the benchmark of `anakin_tpu_torch` on one NVIDIA H100.

`python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once and prints one JSON
line.  Everything a cell is made of is found by name:

  * `configs/<config>.json`: the model configuration as it is run, the
    builder module that serves it (`models/<builder>.py`) and its source;
  * `traffic/<mix>.json`: the parameters of a traffic mix, read by the
    general generator its `"generator"` names (`loads.GENERATORS`);
  * `checks/<cell>.json`: the limit of each number that decides `correct`,
    with the readings it was set from;
  * `metrics/<metric>.py`: the reader of a per-layer metric, by its whole
    name, else by the part of its name before the first dot (a family);
  * `work/<family>.py`: the operations of a whole model step, the
    numerators of `mfu_pct.*`;
  * `roofline/<kernel>.py`: a kernel's launch shapes, operations and bytes,
    and its function names in the device trace; `roofline/peaks.py` the
    published peaks.

`reference/` holds the plain PyTorch references; they import nothing of
the program.  Nothing here imports `jax` or the JAX package.
"""
