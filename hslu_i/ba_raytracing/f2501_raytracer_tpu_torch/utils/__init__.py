from .timing import RenderTiming, TileStats
