"""Launchers: the paper's serving cluster (``launch.serve``), training
(``launch.train``), the meshes (``launch.mesh``) and the multi-pod dry run
(``launch.dryrun``)."""
