"""Analysis layers of the port (port of tpu_pbrt/analysis/): so far the
stub harness of protocheck.py, which the load harness replays traffic
through."""
