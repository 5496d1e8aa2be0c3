"""SRFlow-LP: the flow (``srflow``) and its two-branch prior
(``srflow-unet``)."""
