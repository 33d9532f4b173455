"""Chi-square 95% inverse-CDF table by degrees of freedom (the reference's
``ekf/chi2.py``: chi2inv(0.95, dof), dof 0 mapped to 0)."""
import numpy as np
from scipy.stats import chi2

MAX_DOF = 256
_table = chi2.ppf(0.95, np.arange(MAX_DOF))
_table[0] = 0.0
CHI2INV95 = _table
