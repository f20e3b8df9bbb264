"""Launchers: the paper's serving cluster (``launch.serve``) and training
(``launch.train``)."""
