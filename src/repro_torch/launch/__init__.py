"""launch subpackage: command-line entry points of the port."""
