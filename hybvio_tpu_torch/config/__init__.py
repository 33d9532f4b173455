"""The parameter surface of the port (the reference's ``config`` package
without its file and command-line loader)."""
from .derived import DerivedParameters  # noqa: F401
from .params_generated import (Parameters, ParametersOdometry, ParametersSlam,  # noqa: F401
                               ParametersTracker, parameter_names)
