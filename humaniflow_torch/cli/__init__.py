"""Command-line entry points of the port: `python -m humaniflow_torch.cli.run_predict`."""
