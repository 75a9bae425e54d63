"""Architecture configs (the port's own copy of ``repro.configs``)."""
