"""data subpackage."""
