"""Launchers: the paper's serving cluster (``launch.serve``)."""
