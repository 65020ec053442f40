"""Shared by the port's record tests: a reading held to a release's record
where the JAX package on the same CPU may miss that record too."""


def held_to_record_or_no_farther_than_jax(got, record, jax_run, tol):
    """``got`` within ``tol`` of ``record``, or, where the JAX package on
    this CPU (``jax_run()``, called only then) misses the record by ``tol``
    or more, no farther from it than the JAX package. For a refine with the
    distance, whose mean moves with torch's thread count and parts from the
    JAX package's (ROADMAP C.7)."""
    if abs(got - record) < tol:
        return
    want = jax_run()
    assert abs(want - record) >= tol, (
        f"the port {got:.6f} misses the record {record:.6f}, the JAX package {want:.6f} gives it")
    assert abs(got - record) <= abs(want - record), (got, want, record)
