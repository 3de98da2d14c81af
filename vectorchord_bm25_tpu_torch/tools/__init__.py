"""Operator tools of the port: ``parity_diag`` (classify oracle-parity
mismatches) and ``dryrun`` (one full sharded step on the stacked shards)."""
