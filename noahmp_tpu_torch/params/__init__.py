from .tables import (Params, VegParams, SoilParams, GenParams,
                     load_params, DATA_DIR, VEG_SCHEMES, SOIL_SCHEMES)

__all__ = ["Params", "VegParams", "SoilParams", "GenParams",
           "load_params", "DATA_DIR", "VEG_SCHEMES", "SOIL_SCHEMES"]
