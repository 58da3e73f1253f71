from sphsim.utils.profiling import step_breakdown, trace  # noqa: F401
