# CenterPoint-VoxelNet on nuScenes at 0.1 m (10 sweeps, 6 tasks, velocity head).
# Copied from the reference zoo entry (sparse2dense_tpu/zoo.py: nusc_voxelnet
# '01voxel'), key for key. The detector is ``model`` (no student); the data
# paths are the reference's, relative to the directory training runs in, and
# ``pretrained`` is ignored at build, as in the JAX package.
import itertools

tasks = [
    dict(num_class=1, class_names=["car"]),
    dict(num_class=2, class_names=["truck", "construction_vehicle"]),
    dict(num_class=2, class_names=["bus", "trailer"]),
    dict(num_class=1, class_names=["barrier"]),
    dict(num_class=2, class_names=["motorcycle", "bicycle"]),
    dict(num_class=2, class_names=["pedestrian", "traffic_cone"]),
]
class_names = list(itertools.chain(*[t["class_names"] for t in tasks]))
target_assigner = dict(tasks=tasks)
model = dict(
    type="VoxelNet",
    pretrained=None,
    reader=dict(type="VoxelFeatureExtractorV3", num_input_features=5),
    backbone=dict(
        type="SpMiddleResNetFHD",
        num_input_features=5,
        ds_factor=8,
        engine="window",
        dense_from_stage=1,
        dense_compute_dtype="bfloat16",
        stage_budgets=(280000, 152000, 60000, 56000),
    ),
    neck=dict(
        type="RPN",
        layer_nums=[5, 5],
        ds_layer_strides=[1, 2],
        ds_num_filters=[128, 256],
        us_layer_strides=[1, 2],
        us_num_filters=[256, 256],
        num_input_features=256,
    ),
    bbox_head=dict(
        type="CenterHead",
        in_channels=512,
        tasks=tasks,
        dataset="nuscenes",
        weight=0.25,
        code_weights=[1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.2, 0.2, 1.0, 1.0],
        common_heads=dict(reg=(2, 2), height=(1, 2), dim=(3, 2), rot=(2, 2), vel=(2, 2)),
        share_conv_channel=64,
        dcn_head=False,
    ),
)
assigner = dict(
    target_assigner=target_assigner,
    out_size_factor=8,
    gaussian_overlap=0.1,
    max_objs=500,
    min_radius=2,
)
train_cfg = dict(assigner=assigner)
test_cfg = dict(
    post_center_limit_range=[-61.2, -61.2, -10.0, 61.2, 61.2, 10.0],
    nms=dict(nms_pre_max_size=1000, nms_post_max_size=83, nms_iou_threshold=0.2),
    score_threshold=0.1,
    pc_range=[-51.2, -51.2],
    out_size_factor=8,
    voxel_size=[0.1, 0.1],
)
dataset_type = "NuScenesDataset"
nsweeps = 10
data_root = "data/nuScenes"
db_sampler = dict(
    type="GT-AUG",
    enable=False,
    db_info_path="data/nuScenes/dbinfos_train_10sweeps_withvelo.pkl",
    sample_groups=[
        dict(car=2),
        dict(truck=3),
        dict(construction_vehicle=7),
        dict(bus=4),
        dict(trailer=6),
        dict(barrier=2),
        dict(motorcycle=6),
        dict(bicycle=6),
        dict(pedestrian=2),
        dict(traffic_cone=2),
    ],
    db_prep_steps=[
        dict(
            filter_by_min_num_points=dict(
                car=5,
                truck=5,
                bus=5,
                trailer=5,
                construction_vehicle=5,
                traffic_cone=5,
                barrier=5,
                motorcycle=5,
                bicycle=5,
                pedestrian=5,
            ),
        ),
        dict(filter_by_difficulty=[-1]),
    ],
    global_random_rotation_range_per_object=[0, 0],
    rate=1.0,
)
train_preprocessor = dict(
    mode="train",
    shuffle_points=True,
    global_rot_noise=[-0.3925, 0.3925],
    global_scale_noise=[0.95, 1.05],
    db_sampler=db_sampler,
    class_names=class_names,
)
val_preprocessor = dict(mode="val", shuffle_points=False)
voxel_generator = dict(
    range=[-51.2, -51.2, -5.0, 51.2, 51.2, 3.0],
    voxel_size=[0.1, 0.1, 0.2],
    max_points_in_voxel=10,
    max_voxel_num=[90000, 120000],
)
train_pipeline = [
    dict(type="LoadPointCloudFromFile", dataset="NuScenesDataset"),
    dict(type="LoadPointCloudAnnotations", with_bbox=True),
    dict(type="Preprocess", cfg=train_preprocessor),
    dict(type="Voxelization", cfg=voxel_generator),
    dict(type="AssignLabel", cfg=assigner),
    dict(type="Reformat"),
]
test_pipeline = [
    dict(type="LoadPointCloudFromFile", dataset="NuScenesDataset"),
    dict(type="LoadPointCloudAnnotations", with_bbox=True),
    dict(type="Preprocess", cfg=val_preprocessor),
    dict(type="Voxelization", cfg=voxel_generator),
    dict(type="AssignLabel", cfg=assigner),
    dict(type="Reformat"),
]
train_anno = "data/nuScenes/infos_train_10sweeps_withvelo_filter_True.pkl"
val_anno = "data/nuScenes/infos_val_10sweeps_withvelo_filter_True.pkl"
test_anno = None
data = dict(
    samples_per_gpu=4,
    workers_per_gpu=8,
    train=dict(
        type="NuScenesDataset",
        root_path="data/nuScenes",
        info_path="data/nuScenes/infos_train_10sweeps_withvelo_filter_True.pkl",
        ann_file="data/nuScenes/infos_train_10sweeps_withvelo_filter_True.pkl",
        nsweeps=10,
        class_names=class_names,
        pipeline=train_pipeline,
    ),
    val=dict(
        type="NuScenesDataset",
        root_path="data/nuScenes",
        info_path="data/nuScenes/infos_val_10sweeps_withvelo_filter_True.pkl",
        test_mode=True,
        ann_file="data/nuScenes/infos_val_10sweeps_withvelo_filter_True.pkl",
        nsweeps=10,
        class_names=class_names,
        pipeline=test_pipeline,
    ),
    test=dict(
        type="NuScenesDataset",
        root_path="data/nuScenes",
        info_path=None,
        ann_file=None,
        nsweeps=10,
        class_names=class_names,
        pipeline=test_pipeline,
    ),
)
optimizer_config = dict(grad_clip=dict(max_norm=35, norm_type=2))
optimizer = dict(type="adam", amsgrad=0.0, wd=0.01, fixed_wd=True, moving_average=False)
lr_config = dict(
    type="one_cycle",
    lr_max=0.001,
    moms=[0.95, 0.85],
    div_factor=10.0,
    pct_start=0.4,
)
checkpoint_config = dict(interval=1)
log_config = dict(interval=5, hooks=[dict(type="TextLoggerHook")])
total_epochs = 20
log_level = "INFO"
work_dir = None
load_from = None
resume_from = None
workflow = [("train", 1)]
