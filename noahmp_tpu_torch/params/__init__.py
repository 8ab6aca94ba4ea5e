from .tables import (Params, VegParams, SoilParams, GenParams,
                     load_params, DATA_DIR, VEG_SCHEMES, SOIL_SCHEMES)
from .gathered import gather_params, Gathered, GATHERED_FIELDS

__all__ = ["Params", "VegParams", "SoilParams", "GenParams",
           "load_params", "DATA_DIR", "VEG_SCHEMES", "SOIL_SCHEMES",
           "gather_params", "Gathered", "GATHERED_FIELDS"]
