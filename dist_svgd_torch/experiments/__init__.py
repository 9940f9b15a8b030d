"""Experiment drivers of the port, run as modules
(``python -m dist_svgd_torch.experiments.<name>``)."""
