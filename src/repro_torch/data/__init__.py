"""The seekable token pipeline of the port (counterpart of
``repro/data``)."""
