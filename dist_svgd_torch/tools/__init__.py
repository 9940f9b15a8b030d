"""Measurement tools of the port, run as modules
(``python -m dist_svgd_torch.tools.<name>``)."""
