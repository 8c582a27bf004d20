"""Built-in target posteriors.

The reference builds log-densities with AePPL (ref README.md:27-37); here the
model layer is plain JAX callables ``position -> scalar logprob``, so any
JAX-native logprob (NumPyro, TFP, hand-written) plugs in.  These built-ins
cover the reference's test and benchmark posteriors (BASELINE.md configs).
"""

from aehmc_tpu.models.gaussian import (  # noqa: F401
    correlated_mvn,
    mvn,
    normal,
    std_normal,
)
from aehmc_tpu.models.hierarchical import (  # noqa: F401
    eight_schools,
    neals_funnel,
)
from aehmc_tpu.models.regression import (  # noqa: F401
    linear_regression,
    logistic_regression,
    logistic_regression_data,
)
