"""Entry points of the port: ``launch.serve`` (LM serving with hot weight
swap)."""
