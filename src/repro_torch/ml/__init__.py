"""In-database ML applications over the port's engine (paper §2);
counterpart of ``repro/ml``.  The reference's ``StreamingCube`` and
``OnlineRidge`` need view maintenance, which the port does not have yet."""

from repro_torch.ml.chowliu import ChowLiuResult, chow_liu
from repro_torch.ml.covar import (CovarLayout, assemble_covar, compute_covar,
                                  covar_queries)
from repro_torch.ml.cubes import cube_queries, cube_rollup, cube_via_engine
from repro_torch.ml.forest import GradientBoostedTrees, RandomForest
from repro_torch.ml.polyreg import compute_poly_covar, fit_polyreg, predict_poly
from repro_torch.ml.ridge import RidgeResult, bgd, closed_form, rmse
from repro_torch.ml.trees import DecisionTree

__all__ = ["ChowLiuResult", "chow_liu", "CovarLayout", "assemble_covar",
           "compute_covar", "covar_queries", "cube_queries", "cube_rollup",
           "cube_via_engine", "compute_poly_covar", "fit_polyreg",
           "predict_poly", "RidgeResult", "bgd", "closed_form", "rmse",
           "DecisionTree", "RandomForest", "GradientBoostedTrees"]
