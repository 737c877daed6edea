"""A driver a traffic kind (``kinds/<kind>.py``), imported by the
``kind`` of a traffic mix's file: set-up, the measured window, the
traced slice and the check against the plain reference."""
