"""Tensor-parallel hooks of the port (``specs``): the logical-axis rules
that name each parameter's split axis, and the thread-local TP context
whose ``psum_tp`` the layers call after every row-parallel product."""
