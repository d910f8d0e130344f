"""Configuration for the PyTorch port (a copy of clid_slam_tpu/config.py,
kept here so the port imports nothing of the JAX package).

YAML-compatible with the reference CLID-SLAM configs (the section/key layout
parsed by the reference's utils/config.py:410-900 — ``setting / process /
sampler / neuralpoints / decoder / loss / continual / tracker / optimizer /
eval``), plus a ``tpu`` section for the static-shape capacities this engine
needs (fixed-capacity map slabs, padded scan buckets, hash table sizes).

Unlike the reference's ~200-attribute mutable class, this is a frozen-ish
dataclass; all values that shape jitted programs (capacities, sample counts,
neighbor kernel size) are static Python ints so XLA sees fixed shapes.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import yaml


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@dataclass
class Config:
    # ---- experiment / io (reference utils/config.py:17-47) ----
    use_pin_mapper: bool = False  # PIN-mode projective labels instead of
    # region-specific estimation (reference utils/config.py:18)
    name: str = "clid_slam_tpu"
    run_name: str = ""
    output_root: str = "./experiment"
    # kiss-icp dataloader option (utils/slam_dataset.py:58-81): when on
    # and the optional ``kiss_icp`` package is installed, frames come
    # from kiss_icp.datasets.dataset_factory (mcap/ouster/rosbag/...)
    # instead of the folder loaders
    use_kiss_dataloader: bool = False
    data_loader_name: str = "generic"
    data_loader_seq: str = ""
    # live-view bridge (pipeline/liveview.py): stream poses/scan/map/mesh
    # packets over TCP to tools/live_viewer.py on a workstation — the
    # headless-pod analog of the reference's Open3D GUI (gui/slam_gui.py)
    live_view_on: bool = False
    live_view_port: int = 9876
    pc_path: str = ""
    imu_path: str = ""
    pose_ts_path: str = ""
    pose_path: str = ""
    calib_path: str = ""
    label_path: str = ""
    load_model: bool = False
    model_path: str = ""
    first_frame_ref: bool = False
    begin_frame: int = 0
    end_frame: int = 100000
    step_frame: int = 1
    seed: int = 42

    # ---- dataset specific ----
    kitti_correction_on: bool = False
    correction_deg: float = 0.0
    stop_frame_thre: int = 20
    deskew: bool = False
    valid_ts_in_points: bool = True
    lidar_type_guess: str = "ouster128"

    # ---- preprocess (reference utils/config.py:70-89) ----
    min_range: float = 2.5
    max_range: float = 60.0
    adaptive_range_on: bool = False
    min_z: float = -5.0
    max_z: float = 60.0
    rand_downsample: bool = False
    vox_down_m: float = 0.05
    rand_down_r: float = 1.0

    # ---- semantics / color ----
    semantic_on: bool = False
    sem_class_count: int = 20
    color_map_on: bool = True
    color_on: bool = False
    color_channel: int = 0
    filter_moving_object: bool = False
    use_nclt_bin: bool = False  # NCLT int16 velodyne bin format

    # ---- dynamic filter ----
    dynamic_filter_on: bool = False
    dynamic_certainty_thre: float = 0.5
    dynamic_sdf_ratio_thre: float = 1.5

    # ---- neural point map (reference utils/config.py:109-144) ----
    voxel_size_m: float = 0.3
    local_voxel_size_m: float = 0.2
    weighted_first: bool = True
    layer_norm_on: bool = False
    num_nei_cells: int = 2
    query_nn_k: int = 6
    use_mid_ts: bool = False
    search_alpha: float = 0.2
    feature_dim: int = 8
    feature_std: float = 0.0
    from_sample_points: bool = True
    from_all_samples: bool = False
    map_surface_ratio: float = 0.5
    local_map_travel_dist_ratio: float = 5.0
    local_map_radius: float = 50.0  # derived: max_range + 2
    prune_map_on: bool = False
    max_prune_certainty: float = 3.0
    prune_freq_frame: int = 100

    # ---- training sampler (reference utils/config.py:146-158) ----
    local_map_size: float = 100.0
    surface_sample_range_m: float = 0.25
    surface_sample_n: int = 3
    free_sample_begin_ratio: float = 0.3
    free_sample_end_dist_m: float = 1.0
    free_front_n: int = 2
    free_behind_n: int = 1

    # ---- replay pool (reference utils/config.py:160-165) ----
    window_radius: float = 50.0  # derived: max(max_range, 6)
    pool_capacity: int = int(1e7)
    bs_new_sample: int = 2048
    new_certainty_thre: float = 1.0
    # novelty evaluation: "fast" = own-cell certainty, two random
    # gathers (models/neural_map.py:query_certainty_own_cell — exact up
    # to hash collisions); "certainty" = the reference's full probe
    # (distance-checked, 3 random gathers)
    novelty_mode: str = "fast"
    pool_filter_freq: int = 1

    # ---- decoder MLP (reference utils/config.py:167-181) ----
    mlp_bias_on: bool = True
    mlp_leaky_relu: bool = False
    geo_mlp_level: int = 1
    geo_mlp_hidden_dim: int = 64
    sem_mlp_level: int = 1
    sem_mlp_hidden_dim: int = 64
    color_mlp_level: int = 1
    color_mlp_hidden_dim: int = 64
    decoder_freezed: bool = False
    freeze_after_frame: int = 40
    pos_encoding_band: int = 0  # 0 = no encoding (reference utils/config.py:188)
    pos_input_dim: int = 3
    use_gaussian_pe: bool = False
    pos_encoding_freq: float = 200.0
    pos_encoding_base: float = 2.0

    # ---- loss (reference utils/config.py:192-222) ----
    main_loss_type: str = "bce"
    sigma_sigmoid_m: float = 0.1
    logistic_gaussian_ratio: float = 0.55
    loss_weight_on: bool = False
    behind_dropoff_on: bool = False
    # incidence-corrected freespace labels (r5, beyond the reference):
    # scale free-sample projective labels by sin(incidence) estimated
    # from the region plane fit (mapping/sampler.py rationale)
    incidence_label_on: bool = True
    incidence_min_factor: float = 0.1
    incidence_degenerate_factor: float = 1.0
    free_behind_weight: float = 0.0  # 0 = auto (see _derive)
    dist_weight_on: bool = True
    dist_weight_scale: float = 0.8
    numerical_grad: bool = True
    gradient_decimation: int = 10
    num_grad_step_ratio: float = 0.2
    ekional_loss_on: bool = True
    ekional_add_to: str = "all"
    weight_e: float = 0.5
    weight_s: float = 1.0
    weight_i: float = 1.0

    # ---- optimizer (reference utils/config.py:224-241) ----
    mapping_freq_frame: int = 1
    iters: int = 12
    init_iter_ratio: int = 40
    bs: int = 16384
    lr: float = 0.01
    weight_decay: float = 0.0
    adam_eps: float = 1e-15
    adaptive_iters: bool = False
    lr_pose: float = 1e-4
    ba_freq_frame: int = 0  # 0 = BA off (reference utils/config.py:244)
    ba_frame: int = 50  # sliding window size
    ba_iters: int = 80
    ba_bs: int = 16384
    new_sample_ratio_less: float = 0.02
    new_sample_ratio_more: float = 0.15
    new_sample_ratio_restart: float = 0.3

    # ---- tracker (reference utils/config.py:249-282) ----
    track_on: bool = True
    init_ba: Optional[list] = None  # accelerometer bias prior
    init_bg: Optional[list] = None  # gyro bias prior
    init_gravity: Optional[list] = None
    T_imu_lidar: np.ndarray = field(default_factory=lambda: np.eye(4))
    source_vox_down_m: float = 0.8
    reg_min_grad_norm: float = 0.5
    reg_max_grad_norm: float = 1.5
    track_mask_query_nn_k: int = 6
    # parsed for YAML compat; the reference defines but never reads it
    # (utils/config.py:271 — no use site anywhere in the tree)
    max_sdf_ratio: float = 5.0
    # gates tracker validity at surface_sample_range_m * ratio when
    # weighted_first is off (utils/error_state_iekf.py:238-241)
    max_sdf_std_ratio: float = 1.0
    reg_iter_n: int = 50
    reg_term_thre_deg: float = 0.01
    reg_term_thre_m: float = 0.001
    measurement_noise_covariance: float = 0.01
    bias_noise_covariance: float = 0.0001
    # registration-only source range gate (0 = off, use max_range). The
    # neural map beyond ~single-ring beam support carries coherent
    # decimeter-scale surface bias toward the sensor (measured r4,
    # scripts/diag_large9.py: hall wall at 38 m mapped 8 cm close);
    # mapping still uses the full range, but feeding those points to the
    # IESEKF as if they had texture-level noise drags the pose. The
    # reference has no such gate (it tracks with the full cropped cloud).
    track_max_range: float = 0.0
    # per-point information scale of the SDF measurement (the reference
    # hardcodes 1000, utils/error_state_iekf.py:262 — i.e. sigma ~ 0.03 m
    # per point, treating points as independent). The SDF error field is
    # spatially correlated, so the effective pose information is far
    # lower; sequences with slow-motion phases (sub-texture per-frame
    # displacement) track better with an honest smaller value.
    tracker_info_scale: float = 1000.0

    # ---- eval / vis / meshing (reference utils/config.py:330-385) ----
    wandb_vis_on: bool = False
    silence: bool = True
    o3d_vis_on: bool = False
    log_freq_frame: int = 2000
    mesh_default_on: bool = False
    mesh_freq_frame: int = 20
    sdf_default_on: bool = False
    sdfslice_freq_frame: int = 1
    sdf_slice_height: float = -1.0
    # also write the vertical (y-z) SDF slice (utils/config.py:344)
    vis_sdf_slice_v: bool = False
    vis_sdf_res_m: float = 0.2
    eval_traj_align: bool = True
    mc_res_m: float = 0.1
    pad_voxel: int = 2
    skip_top_voxel: int = 2
    mc_mask_on: bool = True
    mesh_min_nn: int = 8
    min_cluster_vertices: int = 300
    infer_bs: int = 4096
    save_map: bool = False
    save_merged_pc: bool = False
    save_mesh: bool = False

    # ---- TPU-native static-shape capacities (new; no reference analog) ----
    # neural point map slab capacity (points) and hash table size
    map_capacity: int = 2 ** 20
    map_hash_size: int = 2 ** 22
    # raw-point local map capacity and hash size
    local_map_capacity: int = 2 ** 21
    local_map_hash_size: int = 2 ** 22
    # padded per-frame scan size after preprocessing (static shape bucket)
    max_scan_points: int = 2 ** 15
    # padded source-cloud size for tracking
    max_source_points: int = 2 ** 13
    # padded per-frame voxel-downsampled insertion batch
    max_update_points: int = 2 ** 15
    # use bfloat16 for decoder matmuls
    mlp_bf16: bool = False
    # ---- accuracy/speed trade knobs (each r2 approximation is separately
    # disableable so its ATE cost is measurable; scripts/ablate_accuracy.py)
    # candidate-cached tracker in the streaming loop (one hash probe per
    # frame) vs full re-query every IESEKF iteration
    track_cached: bool = True
    # cached-tracker candidate count; 0 = auto (max(16, 2*query_nn_k))
    track_n_cand: int = 0
    # Adam steps per fresh batch+probe in the cached mapping loop
    # (1 = fresh batch every step, the reference cadence)
    map_resample_every: int = 10
    # expanded-duplicates mapping (mapper.py dup_independent docstring):
    # the streaming fast path trains the [bs,k] kNN references as
    # independent parameters and writes back per-point means once per
    # frame -- zero per-iteration gathers/scatters. None = auto: on for
    # the bce loss (A/B-validated on both bench scales), OFF for
    # zhong/sdf_l1/sdf_l2 where the approximation has no accuracy
    # evidence (advisor r4); set True/False to force either path
    map_dup_independent: "bool | None" = None
    # run the whole mapping inner loop as ONE Pallas TPU kernel
    # (ops/pallas_mapping.py; requires dup_independent; auto-falls back
    # to the XLA loop off-TPU or for ineligible configs)
    map_pallas: bool = True
    # tracker iteration after which the f32 stagnation exit may fire;
    # set >= reg_iter_n to disable
    stagnation_iter: int = 10

    # derived values filled by __post_init__/load
    sdf_scale: float = 0.055
    diff_travel_dist_local: float = 260.0

    def __post_init__(self):
        self._derive()

    def resolved_free_behind_weight(self) -> float:
        """Near-surface BCE mass balance. With incidence-corrected
        labels the front/behind free samples carry comparable (metric)
        magnitudes near a grazing surface, so the n_front/n_behind
        count imbalance shifts the smoothed zero crossing toward the
        heavier side (measured: 200-frame hall z ratchet, large ATE
        0.226 -> 0.119 with the balance on). 0 = auto: equalize by
        n_front/n_behind when incidence labels are on, else keep the
        reference's unit weights (its saturated projective behind
        labels already pull harder per sample)."""
        if self.free_behind_weight:
            return self.free_behind_weight
        if self.incidence_label_on and self.free_behind_n > 0:
            return self.free_front_n / self.free_behind_n
        return 1.0

    def _derive(self):
        self.run_name = self.run_name or self.name
        if self.main_loss_type == "bce":
            self.sdf_scale = self.logistic_gaussian_ratio * self.sigma_sigmoid_m
        else:
            self.sdf_scale = 1.0
        # reference utils/config.py:902-910
        self.infer_bs = self.bs * 64
        self.window_radius = max(self.max_range, 6.0)
        self.local_map_radius = self.max_range + 2.0
        self.vis_sdf_res_m = self.voxel_size_m * 0.3
        self.diff_travel_dist_local = (
            self.local_map_radius * self.local_map_travel_dist_ratio
        )
        self.track_mask_query_nn_k = self.query_nn_k
        if self.map_dup_independent is None:
            # auto: the expanded-duplicates approximation is A/B-validated
            # for bce only (advisor r4) — other loss types take the exact
            # summed-gradient XLA path unless forced
            self.map_dup_independent = self.main_loss_type == "bce"

    @property
    def position_dim(self) -> int:
        """Encoded relative-vector width appended to the interpolated
        feature (reference model/decoder.py:28-31)."""
        if self.pos_encoding_band <= 0:
            return self.pos_input_dim
        if self.use_gaussian_pe:
            return self.pos_input_dim + 2 * self.pos_encoding_band
        return self.pos_input_dim * (2 * self.pos_encoding_band + 1)

    @property
    def all_sample_n(self) -> int:
        """Samples per ray: endpoint + surface + freespace front/behind."""
        return 1 + self.surface_sample_n + self.free_front_n + self.free_behind_n

    @property
    def num_grad_eps(self) -> float:
        return self.voxel_size_m * self.num_grad_step_ratio

    @staticmethod
    def load(config_file: str) -> "Config":
        """Load a reference-format YAML (section layout of the
        reference's utils/config.py:410-900)."""
        with open(os.path.abspath(config_file)) as f:
            args = yaml.safe_load(f)
        return Config.from_dict(args or {})

    @staticmethod
    def from_dict(args: dict) -> "Config":
        c = Config()
        c.run_name = ""  # recompute from the loaded name in _derive
        s = args.get("setting", {}) or {}
        c.use_pin_mapper = s.get("use_pin_mapper", False)
        c.name = s.get("name", c.name)
        c.output_root = s.get("output_root", c.output_root)
        c.use_kiss_dataloader = s.get(
            "use_kiss_icp_dataloader", c.use_kiss_dataloader
        )
        c.data_loader_name = s.get("data_loader_name", c.data_loader_name)
        c.data_loader_seq = s.get("data_loader_seq", c.data_loader_seq)
        c.live_view_on = s.get("live_view_on", c.live_view_on)
        c.live_view_port = int(s.get("live_view_port", c.live_view_port))
        c.pc_path = s.get("pc_path", c.pc_path)
        c.imu_path = s.get("imu_path", c.imu_path)
        c.pose_path = s.get("pose_path", c.pose_path)
        c.pose_ts_path = s.get("pose_ts_path", c.pose_ts_path)
        c.calib_path = s.get("calib_path", c.calib_path)
        c.semantic_on = s.get("semantic_on", c.semantic_on)
        if c.semantic_on:
            c.label_path = s.get("label_path", c.label_path)
            c.filter_moving_object = s.get(
                "filter_moving_object", c.filter_moving_object
            )
        c.use_nclt_bin = s.get("nclt_bin", c.use_nclt_bin)
        c.color_map_on = s.get("color_map_on", c.color_map_on)
        c.color_channel = s.get("color_channel", 0)
        c.color_on = bool(
            (c.color_channel in (1, 3)) and c.color_map_on
        )
        c.load_model = s.get("load_model", c.load_model)
        if c.load_model:
            c.model_path = s.get("model_path", "")
        c.first_frame_ref = s.get("first_frame_ref", c.first_frame_ref)
        c.begin_frame = s.get("begin_frame", 0)
        c.end_frame = s.get("end_frame", c.end_frame)
        c.step_frame = s.get("step_frame", 1)
        c.seed = s.get("random_seed", c.seed)
        c.kitti_correction_on = s.get("kitti_correct", c.kitti_correction_on)
        if c.kitti_correction_on:
            c.correction_deg = s.get("correct_deg", c.correction_deg)
        c.stop_frame_thre = s.get("stop_frame_thre", c.stop_frame_thre)
        c.deskew = s.get("deskew", c.deskew)
        c.valid_ts_in_points = s.get("valid_ts", c.valid_ts_in_points)
        if c.step_frame > 1:
            c.deskew = False

        p = args.get("process", {}) or {}
        c.min_range = p.get("min_range_m", c.min_range)
        c.max_range = p.get("max_range_m", c.max_range)
        c.min_z = p.get("min_z_m", c.min_z)
        c.max_z = p.get("max_z_m", c.max_z)
        c.rand_downsample = p.get("rand_downsample", c.rand_downsample)
        if c.rand_downsample:
            c.rand_down_r = p.get("rand_down_r", c.rand_down_r)
        else:
            c.vox_down_m = p.get("vox_down_m", c.max_range * 1e-3)
        c.dynamic_filter_on = p.get("dynamic_filter_on", c.dynamic_filter_on)
        c.dynamic_sdf_ratio_thre = p.get(
            "dynamic_sdf_ratio_thre", c.dynamic_sdf_ratio_thre
        )
        c.dynamic_certainty_thre = p.get(
            "dynamic_certainty_thre", c.dynamic_certainty_thre
        )
        c.adaptive_range_on = p.get("adaptive_range_on", c.adaptive_range_on)

        sp = args.get("sampler", {}) or {}
        c.local_voxel_size_m = sp.get("local_voxel_size_m", c.vox_down_m)
        c.surface_sample_range_m = sp.get(
            "surface_sample_range_m", c.vox_down_m * 3.0
        )
        c.free_sample_begin_ratio = sp.get(
            "free_sample_begin_ratio", c.free_sample_begin_ratio
        )
        c.free_sample_end_dist_m = sp.get(
            "free_sample_end_dist_m", c.surface_sample_range_m * 4.0
        )
        c.surface_sample_n = sp.get("surface_sample_n", c.surface_sample_n)
        c.free_front_n = sp.get("free_front_sample_n", c.free_front_n)
        c.free_behind_n = sp.get("free_behind_sample_n", c.free_behind_n)

        npt = args.get("neuralpoints", {}) or {}
        c.voxel_size_m = npt.get("voxel_size_m", c.vox_down_m * 5.0)
        c.query_nn_k = npt.get("query_nn_k", c.query_nn_k)
        c.num_nei_cells = npt.get("num_nei_cells", c.num_nei_cells)
        c.layer_norm_on = npt.get("layer_norm_on", c.layer_norm_on)
        c.search_alpha = npt.get("search_alpha", c.search_alpha)
        c.feature_dim = npt.get("feature_dim", c.feature_dim)
        c.weighted_first = npt.get("weighted_first", c.weighted_first)
        c.from_sample_points = npt.get("from_sample_points", c.from_sample_points)
        if c.from_sample_points:
            c.map_surface_ratio = npt.get("map_surface_ratio", c.map_surface_ratio)
        c.prune_map_on = npt.get("prune_map_on", c.prune_map_on)
        c.max_prune_certainty = npt.get(
            "max_prune_certainty", c.max_prune_certainty
        )
        c.use_mid_ts = npt.get("use_mid_ts", c.use_mid_ts)
        c.local_map_travel_dist_ratio = npt.get(
            "local_map_travel_dist_ratio", c.local_map_travel_dist_ratio
        )

        d = args.get("decoder", {}) or {}
        c.geo_mlp_level = d.get("mlp_level", c.geo_mlp_level)
        c.geo_mlp_hidden_dim = d.get("mlp_hidden_dim", c.geo_mlp_hidden_dim)
        c.freeze_after_frame = d.get("freeze_after_frame", c.freeze_after_frame)
        c.pos_encoding_band = d.get("pos_encoding_band", c.pos_encoding_band)
        c.use_gaussian_pe = d.get("use_gaussian_pe", c.use_gaussian_pe)
        c.pos_encoding_freq = float(
            d.get("pos_encoding_freq", c.pos_encoding_freq)
        )
        c.pos_encoding_base = float(
            d.get("pos_encoding_base", c.pos_encoding_base)
        )

        lo = args.get("loss", {}) or {}
        c.main_loss_type = lo.get("main_loss_type", "bce")
        if c.main_loss_type not in ("bce", "zhong", "sdf_l1", "sdf_l2"):
            # fail loudly (ref utils/mapper.py:766-767 sys.exit) instead of
            # silently proceeding with wrong loss semantics
            raise ValueError(
                f"unsupported loss.main_loss_type {c.main_loss_type!r}; "
                "choose bce | zhong | sdf_l1 | sdf_l2"
            )
        c.sigma_sigmoid_m = lo.get("sigma_sigmoid_m", c.sigma_sigmoid_m)
        c.loss_weight_on = lo.get("loss_weight_on", c.loss_weight_on)
        if c.loss_weight_on:
            c.dist_weight_scale = lo.get("dist_weight_scale", c.dist_weight_scale)
            c.behind_dropoff_on = lo.get("behind_dropoff_on", c.behind_dropoff_on)
            c.incidence_label_on = lo.get(
                "incidence_label_on", c.incidence_label_on
            )
            c.incidence_min_factor = lo.get(
                "incidence_min_factor", c.incidence_min_factor
            )
            c.incidence_degenerate_factor = lo.get(
                "incidence_degenerate_factor",
                c.incidence_degenerate_factor,
            )
            c.free_behind_weight = lo.get(
                "free_behind_weight", c.free_behind_weight
            )
        c.ekional_loss_on = lo.get("ekional_loss_on", c.ekional_loss_on)
        c.weight_e = float(lo.get("weight_e", c.weight_e))
        c.numerical_grad = lo.get("numerical_grad_on", c.numerical_grad)
        if c.numerical_grad:
            c.gradient_decimation = lo.get(
                "grad_decimation", c.gradient_decimation
            )
            c.num_grad_step_ratio = lo.get(
                "num_grad_step_ratio", c.num_grad_step_ratio
            )

        co = args.get("continual", {}) or {}
        c.pool_capacity = int(float(co.get("pool_capacity", c.pool_capacity)))
        c.bs_new_sample = int(
            co.get("batch_size_new_sample", c.bs_new_sample)
        )
        c.new_certainty_thre = float(
            co.get("new_certainty_thre", c.new_certainty_thre)
        )
        c.pool_filter_freq = co.get("pool_filter_freq", 1)

        tr = args.get("tracker", None)
        c.track_on = bool(tr)
        if tr:
            c.T_imu_lidar = np.array(
                tr.get("T_imu_lidar", np.eye(4)), dtype=np.float64
            )
            if tr.get("ba") is not None:
                c.init_ba = list(tr["ba"])
            if tr.get("bg") is not None:
                c.init_bg = list(tr["bg"])
            if tr.get("gravity") is not None:
                c.init_gravity = list(tr["gravity"])
            c.source_vox_down_m = tr.get("source_vox_down_m", c.source_vox_down_m)
            c.reg_iter_n = tr.get("iter_n", c.reg_iter_n)
            c.reg_min_grad_norm = tr.get("min_grad_norm", c.reg_min_grad_norm)
            c.reg_max_grad_norm = tr.get("max_grad_norm", c.reg_max_grad_norm)
            c.reg_term_thre_deg = tr.get("term_deg", c.reg_term_thre_deg)
            c.reg_term_thre_m = tr.get("term_m", c.reg_term_thre_m)
            c.measurement_noise_covariance = tr.get(
                "measurement_noise_covariance", c.measurement_noise_covariance
            )
            c.bias_noise_covariance = tr.get(
                "bias_noise_covariance", c.bias_noise_covariance
            )
            c.track_max_range = tr.get("track_max_range", c.track_max_range)
            c.tracker_info_scale = tr.get(
                "tracker_info_scale", c.tracker_info_scale
            )

        o = args.get("optimizer", {}) or {}
        c.mapping_freq_frame = o.get("mapping_freq_frame", c.mapping_freq_frame)
        c.adaptive_iters = o.get("adaptive_iters", c.adaptive_iters)
        c.iters = o.get("iters", c.iters)
        c.init_iter_ratio = o.get("init_iter_ratio", c.init_iter_ratio)
        c.new_sample_ratio_more = o.get(
            "new_sample_ratio_more", c.new_sample_ratio_more
        )
        c.bs = o.get("batch_size", c.bs)
        c.lr = float(o.get("learning_rate", c.lr))
        c.ba_freq_frame = o.get("ba_freq_frame", c.ba_freq_frame)
        c.ba_frame = o.get("ba_local_frame", c.ba_frame)
        c.lr_pose = float(o.get("lr_pose_ba", c.lr_pose))
        c.ba_iters = int(o.get("ba_iters", c.ba_iters))
        c.ba_bs = int(o.get("ba_bs", c.ba_bs))

        e = args.get("eval", {}) or {}
        c.wandb_vis_on = e.get("wandb_vis_on", c.wandb_vis_on)
        c.silence = e.get("silence_log", c.silence)
        c.o3d_vis_on = e.get("o3d_vis_on", c.o3d_vis_on)
        c.log_freq_frame = e.get("log_freq_frame", c.log_freq_frame)
        c.mesh_freq_frame = e.get("mesh_freq_frame", c.mesh_freq_frame)
        c.sdf_default_on = e.get("sdf_default_on", c.sdf_default_on)
        c.sdfslice_freq_frame = e.get("sdf_freq_frame", c.sdfslice_freq_frame)
        c.sdf_slice_height = e.get("sdf_slice_height", c.sdf_slice_height)
        c.vis_sdf_slice_v = e.get("vis_sdf_slice_v", c.vis_sdf_slice_v)
        c.mesh_default_on = e.get("mesh_default_on", c.mesh_default_on)
        c.mesh_min_nn = e.get("mesh_min_nn", c.mesh_min_nn)
        c.skip_top_voxel = e.get("skip_top_voxel", c.skip_top_voxel)
        c.min_cluster_vertices = e.get(
            "min_cluster_vertices", c.min_cluster_vertices
        )
        c.mc_res_m = e.get("mc_res_m", c.voxel_size_m)
        c.save_map = e.get("save_map", c.save_map)
        c.save_merged_pc = e.get("save_merged_pc", c.save_merged_pc)
        c.save_mesh = e.get("save_mesh", c.save_mesh)

        t = args.get("tpu", {}) or {}
        for k in (
            "map_capacity",
            "map_hash_size",
            "local_map_capacity",
            "local_map_hash_size",
            "max_scan_points",
            "max_source_points",
            "max_update_points",
            "pool_capacity",
        ):
            if k in t:
                setattr(c, k, _next_pow2(int(float(t[k]))))
        if "mlp_bf16" in t:
            c.mlp_bf16 = bool(t["mlp_bf16"])
        if "track_cached" in t:
            c.track_cached = bool(t["track_cached"])
        if "novelty_mode" in t:
            c.novelty_mode = str(t["novelty_mode"])
        if "map_dup_independent" in t:
            c.map_dup_independent = bool(t["map_dup_independent"])
        else:
            # re-resolve the auto default against the LOADED loss type
            # (construction already ran _derive with the dataclass
            # default loss)
            c.map_dup_independent = None
        for k in ("track_n_cand", "map_resample_every", "stagnation_iter"):
            if k in t:
                setattr(c, k, int(t[k]))

        c._derive()
        return c

    def replace(self, **kw) -> "Config":
        new = dataclasses.replace(self)
        for k, v in kw.items():
            setattr(new, k, v)
        new._derive()
        return new
