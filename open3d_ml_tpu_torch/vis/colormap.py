"""A piecewise-linear colormap for shading points by a scalar.

Counterpart of ``open3d_ml_tpu/vis/colormap.py`` (numpy only).
"""

import numpy as np


class Colormap:
    """Piecewise-linear colormap over [0, 1]."""

    class Point:

        def __init__(self, value, color):
            assert 0.0 <= value <= 1.0
            self.value = value
            self.color = color

        def __repr__(self):
            return f"Colormap.Point({self.value}, {self.color})"

    def __init__(self, points):
        self.points = points

    @staticmethod
    def calc_u_array(values, range_min, range_max):
        """The values scaled into [0, 1] over [range_min, range_max]."""
        values = np.asarray(values, np.float64)
        width = max(range_max - range_min, 1e-12)
        return np.clip((values - range_min) / width, 0.0, 1.0)

    def calc_color_array(self, values, range_min, range_max):
        """RGB colours [N, 3] of the values, interpolated linearly between
        the points."""
        u = self.calc_u_array(values, range_min, range_max)
        xp = np.array([p.value for p in self.points])
        fp = np.array([p.color for p in self.points])  # [P, 3]
        return np.stack([np.interp(u, xp, fp[:, c]) for c in range(3)],
                        axis=-1)

    @staticmethod
    def make_greyscale():
        """Black to white."""
        return Colormap([
            Colormap.Point(0.0, [0.0, 0.0, 0.0]),
            Colormap.Point(1.0, [1.0, 1.0, 1.0]),
        ])

    @staticmethod
    def make_rainbow():
        """Blue through green to red."""
        return Colormap([
            Colormap.Point(0.000, [0.0, 0.0, 1.0]),
            Colormap.Point(0.125, [0.0, 0.5, 1.0]),
            Colormap.Point(0.250, [0.0, 1.0, 1.0]),
            Colormap.Point(0.375, [0.0, 1.0, 0.5]),
            Colormap.Point(0.500, [0.0, 1.0, 0.0]),
            Colormap.Point(0.625, [0.5, 1.0, 0.0]),
            Colormap.Point(0.750, [1.0, 1.0, 0.0]),
            Colormap.Point(0.875, [1.0, 0.5, 0.0]),
            Colormap.Point(1.000, [1.0, 0.0, 0.0]),
        ])
