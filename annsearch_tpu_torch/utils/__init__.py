from .dist import Dist, parse_ann_dist  # noqa: F401
