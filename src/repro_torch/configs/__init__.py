"""Configurations of the port: the paper's MemEC testbed."""


def memec_config():
    from . import memec
    return memec.CONFIG
