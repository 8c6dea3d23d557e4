"""Map container: points + compiled device indexes (src/mcl_3dl.cpp:
1150-1170 map load with voxel downsample; :1350-1378 the periodic merge
of ``mapcloud_update``).

"Compiling" the map builds the likelihood distance field ``df`` (with
the corner pack of trilinear sampling), the label-filtered beam field
``df_beam`` on the same grid, so one pose-grouped particle layout serves
both measurement kernels, and the occupancy grid ``occ`` of the DDA
raycast.  A merge rebuilds all of them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from mcl_3dl_tpu_torch.config import Params
from mcl_3dl_tpu_torch.map.distance_field import (DistanceField,
                                                  build_distance_field)
from mcl_3dl_tpu_torch.map.occupancy import OccupancyGrid, build_occupancy_grid
from mcl_3dl_tpu_torch.map.voxel import voxel_downsample


@dataclass
class MapData:
    points: np.ndarray                    # [M, 3] downsampled map points (host)
    labels: np.ndarray                    # [M] uint32
    df: DistanceField                     # likelihood / general radius queries
    df_beam: DistanceField                # raycast field (label-filtered)
    occ: Optional[OccupancyGrid]          # DDA raycast grid
    params: Params

    @classmethod
    def build(cls, points, params: Params, labels: Optional[np.ndarray] = None,
              device=None, downsample: bool = True) -> "MapData":
        """Build from a raw map cloud; ``downsample`` applies the map voxel
        grid (map_downsample_x/y/z, src/mcl_3dl.cpp:1155-1158) first."""
        points = np.asarray(points, np.float64).reshape(-1, 3)
        if labels is None:
            labels = np.zeros((points.shape[0],), np.uint32)
        if downsample and points.shape[0] > 0:
            points, attrs = voxel_downsample(
                points,
                (params.map_downsample_x, params.map_downsample_y,
                 params.map_downsample_z),
                attrs=np.asarray(labels, np.float64)[:, None],
            )
            labels = np.round(attrs[:, 0]).astype(np.uint32)
        else:
            labels = np.asarray(labels).astype(np.uint32)

        cell = params.df_cell_size or params.map_grid_min
        # truncation covers every radius query: likelihood match,
        # unmatched classification and kd-tree raycast probes
        trunc = max(
            params.likelihood.match_dist_min,
            params.unmatch_output_dist,
            np.sqrt(2.0) * params.map_grid_max / 2.0 + 2.0 * params.map_grid_min,
        ) + 2.0 * cell
        df = build_distance_field(points, cell, trunc, params.dist_weight,
                                  device=device)
        # points labelled above filter_label_max are transparent to rays
        # (lidar_measurement_model_beam.cpp:168-169)
        visible = labels <= params.beam.filter_label_max
        if visible.all():
            df_beam = df
        else:
            # raycasts sample the nearest cell only: no corner pack
            df_beam = build_distance_field(
                points[visible], cell, trunc, params.dist_weight,
                grid=(df.origin.cpu().numpy().astype(np.float64), df.shape),
                device=device, pack_corners=False)
        occ = build_occupancy_grid(points, params.beam.dda_grid_size, labels,
                                   device=device)
        return cls(points=points, labels=labels, df=df, df_beam=df_beam,
                   occ=occ, params=params)

    def merged_with(self, update_points, update_labels=None) -> "MapData":
        """Merge an update cloud and recompile every index on the same
        device (src/mcl_3dl.cpp:1355-1369).  The update cloud is expected
        downsampled at the update leaf size (cbMapcloudUpdate, :141-153);
        the merged cloud is not downsampled again, as ``*pc_map2_ =
        *pc_map_ + *pc_update_``."""
        update_points = np.asarray(update_points, np.float64).reshape(-1, 3)
        if update_labels is None:
            update_labels = np.zeros((update_points.shape[0],), np.uint32)
        merged = np.concatenate([self.points, update_points], axis=0)
        merged_labels = np.concatenate(
            [self.labels, np.asarray(update_labels, np.uint32)])
        return MapData.build(merged, self.params, merged_labels,
                             device=self.df.device, downsample=False)
