"""Model configurations of the port (copies of ``repro/configs``)."""
