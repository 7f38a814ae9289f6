"""PromQL function registry (reference query/PlanEnums.scala — 28 range
functions :52-85, 26 instant functions :8-35, 12 aggregation ops :99-113).

Maps surface names to kernel names plus argument shapes: which positional
argument is the vector/matrix and which are scalars.
"""

from __future__ import annotations

# range functions: surface name -> (kernel name, n_scalar_args, scalars_first)
RANGE_FUNCTIONS: dict[str, tuple[str, int, bool]] = {
    "rate": ("rate", 0, False),
    "increase": ("increase", 0, False),
    "delta": ("delta", 0, False),
    "idelta": ("idelta", 0, False),
    "irate": ("irate", 0, False),
    "resets": ("resets", 0, False),
    "changes": ("changes", 0, False),
    "deriv": ("deriv", 0, False),
    "predict_linear": ("predict_linear", 1, False),  # (m[d], t)
    "avg_over_time": ("avg_over_time", 0, False),
    "min_over_time": ("min_over_time", 0, False),
    "max_over_time": ("max_over_time", 0, False),
    "sum_over_time": ("sum_over_time", 0, False),
    "count_over_time": ("count_over_time", 0, False),
    "stddev_over_time": ("stddev_over_time", 0, False),
    "stdvar_over_time": ("stdvar_over_time", 0, False),
    "last_over_time": ("last_over_time", 0, False),
    "first_over_time": ("first_over_time", 0, False),
    "present_over_time": ("present_over_time", 0, False),
    "absent_over_time": ("absent_over_time", 0, False),
    "quantile_over_time": ("quantile_over_time", 1, True),  # (q, m[d])
    "median_absolute_deviation_over_time": ("median_absolute_deviation_over_time", 0, False),
    "mad_over_time": ("median_absolute_deviation_over_time", 0, False),
    "holt_winters": ("double_exponential_smoothing", 2, False),  # (m[d], sf, tf)
    "double_exponential_smoothing": ("double_exponential_smoothing", 2, False),
    "timestamp_of_last_sample": ("timestamp", 0, False),
    "z_score": ("z_score", 0, False),
    "rate_over_delta": ("rate", 0, False),  # delta-counter rate alias
    "increase_over_delta": ("increase", 0, False),
    "avg_with_sum_and_count_over_time": ("avg_over_time", 0, False),
    # (tolerance, bounds_mode, rv) — reference LastOverTimeIsMadOutlier
    "last_over_time_is_mad_outlier": ("last_over_time_is_mad_outlier", 2, True),
}

# instant functions applied elementwise on [S, J] grids
INSTANT_FUNCTIONS = {
    "abs", "ceil", "exp", "floor", "ln", "log2", "log10", "sqrt", "sgn",
    "acos", "acosh", "asin", "asinh", "atan", "atanh", "cos", "cosh", "sin",
    "sinh", "tan", "tanh", "deg", "rad",
    "clamp", "clamp_max", "clamp_min", "round", "or_vector",
    "histogram_quantile", "histogram_fraction", "histogram_max_quantile",
    "histogram_max_quantile_even", "histogram_bucket",
    "hist_to_prom_vectors",
    "timestamp",
}

# misc functions handled host-side on labels / ordering
MISC_FUNCTIONS = {
    "label_replace", "label_join", "sort", "sort_desc", "absent", "scalar",
    "vector", "limit", "optimize_with_agg", "no_optimize",
    "_filodb_chunkmeta_all",
}

# 0-arity or optional-vector time functions
TIME_FUNCTIONS = {
    "time", "minute", "hour", "month", "year", "day_of_month", "day_of_week",
    "day_of_year", "days_in_month", "pi",
}

AGGREGATION_OPS = {
    "sum", "min", "max", "avg", "count", "stddev", "stdvar", "group",
    "topk", "bottomk", "quantile", "count_values", "limitk", "limit_ratio",
}

# aggregators with a leading parameter
AGG_WITH_PARAM = {"topk", "bottomk", "quantile", "count_values", "limitk", "limit_ratio"}

COMPARISON_OPS = {"==", "!=", ">", "<", ">=", "<="}
SET_OPS = {"and", "or", "unless"}
ARITH_OPS = {"+", "-", "*", "/", "%", "^", "atan2"}
