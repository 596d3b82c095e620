"""Traffic: a mix is ``<name>.json`` (its parameters and its ``kind``),
read by the driver of its kind, ``<kind>.py``."""
