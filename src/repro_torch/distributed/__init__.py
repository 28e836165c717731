"""distributed subpackage: meshes laid out on one card as leading tensor
dimensions - sharding rules and local views, the XOR and GF(2^8)
collectives over a stacked axis, the erasure-coded state store and the
elastic fleet monitor."""
