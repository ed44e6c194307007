from .settings import TILE, GaussianInputs, RasterConfig, ViewParams  # noqa: F401
from .preprocess import PreprocessOut, preprocess  # noqa: F401
from .binning import BinnedSplats, build_tile_lists  # noqa: F401
from .render import (BlendInputs, blend_tiles, composite_background,  # noqa: F401
                     prepare_blend, render)
