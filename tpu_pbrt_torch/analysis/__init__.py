"""Analysis layers of the port (counterpart of tpu_pbrt/analysis/).

- `lint.py`: AST rules over the package's hot set (JL-SYNC, JL-F64,
  JL-DTYPE, JL-ENV) with `# torchlint: disable=` pragmas under a budget;
- `record.py`: the op recorder, a TorchDispatchMode over a real run, in
  place of the reference's traced jaxpr;
- `audit.py`: the entry points recorded at the reference's tiny scenes,
  and the hot-path invariants checked on them;
- `cost.py`: static FLOPs, bytes and ops per wave of each entry point,
  gated against the committed `budgets.json`;
- `protocheck.py`: the stub harness the load harness replays traffic
  through.

`python -m tpu_pbrt_torch.analysis [--device cpu]` runs lint, audit and
the cost gate (`__main__.py`).
"""
