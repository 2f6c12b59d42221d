"""Inputs shared by the port's tests and ``chip_smoke.py``.  Imports
nothing of JAX, so the card-side checks can use it where JAX is absent."""


def wide_routes(k):
    """A static route table whose destinations reach k - 1, with a pin, an
    exclude list and two hashed terms."""
    return (
        (k - 40_000, ((0, 0x9E3779B9, 20_000, 2),), (0, 1), (), ((1, (3, 4)),)),
        (5, ((1, 12_345, 7, 1), (0, 999, 3, 7)), (0,), ((0, 7),), ()),
        (k - 1, (), (0,), (), ()),
    )
