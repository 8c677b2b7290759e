"""Several devices: data-parallel training across ranks (``mesh``) and
tensor-parallel serving in one process (``tp``)."""
