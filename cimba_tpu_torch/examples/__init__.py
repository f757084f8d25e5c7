"""User programs of the reference's ``examples/``, restated for the port:
``build()`` and ``params()`` each.  They use only the model DSL, so on the
card they run through the generated chunk kernel (``core/emit.py``)."""
