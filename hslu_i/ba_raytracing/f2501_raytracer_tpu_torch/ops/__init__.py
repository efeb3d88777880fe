from . import camera, colorops, intersect, sampling, shading, trace, vecmath
