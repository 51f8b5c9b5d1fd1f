"""The reference's four examples (`examples/` at the repo root) as modules
of the port, each run as ``python -m repro_torch.examples.<name>`` on the
card, or with ``--device cpu`` on the plain path."""
