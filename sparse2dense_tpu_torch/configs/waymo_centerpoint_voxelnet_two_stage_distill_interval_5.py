# CenterPoint-VoxelNet Sparse2Dense on Waymo, two-stage: the flagship
# KD_VoxelNet + S2D_RPN student as the frozen first stage, BEV features at 5
# points a box (stride 8, 512 channels: 2,560 a RoI) and the RoI head over
# its 500 detections a frame. Copied from the reference zoo entry
# (sparse2dense_tpu/zoo.py: _voxelnet_model, _two_stage_model,
# _ROI_HEAD_MODEL_CFG, the assigner, train_cfg, test_cfg, voxel_generator,
# the data block and _runtime of waymo_voxelnet_two_stage
# "distill_interval_5"), trained 6 epochs at samples_per_gpu=6. The first
# stage's ``pretrained`` names the flagship's last det3d checkpoint; it is
# ignored at build (as in the JAX package): its weights come from
# tools/convert_checkpoint.py and tools/test.py --checkpoint.
import itertools

tasks = [dict(num_class=3, class_names=["VEHICLE", "PEDESTRIAN", "CYCLIST"])]
class_names = list(itertools.chain(*[t["class_names"] for t in tasks]))
target_assigner = dict(tasks=tasks)


def _kd_voxelnet():
    return dict(
        type="KD_VoxelNet",
        pretrained=("./work_dirs/waymo_centerpoint_voxelnet_3x_distill_interval_5/"
                    "epoch_30.pth"),
        reader=dict(type="VoxelFeatureExtractorV3", num_input_features=5),
        # windowed sparse engine for conv1 and conv2_down, masked dense bf16
        # 3D convs from conv2 on; the conv2 row budget covers the dilated
        # active set of a 150k-voxel Waymo frame
        backbone=dict(type="SpMiddleResNetFHD", num_input_features=5,
                      ds_factor=8, engine="window", dense_from_stage=1,
                      dense_compute_dtype="bfloat16",
                      stage_budgets=(320000, 210000, 90000, 48000)),
        neck=dict(
            type="S2D_RPN",
            layer_nums=[5, 5], ds_layer_strides=[1, 2], ds_num_filters=[128, 256],
            us_layer_strides=[1, 2], us_num_filters=[256, 256],
            num_input_features=256,
        ),
        bbox_head=dict(
            type="CenterHead", in_channels=512, tasks=tasks, dataset="waymo",
            weight=2, code_weights=[1.0] * 8,
            common_heads={"reg": (2, 2), "height": (1, 2), "dim": (3, 2),
                          "rot": (2, 2)},
        ),
    )


S_model = dict(
    type="TwoStageDetector",
    first_stage_cfg=_kd_voxelnet(),
    second_stage_modules=[dict(type="BEVFeatureExtractor", pc_start=[-75.2, -75.2],
                               voxel_size=[0.1, 0.1], out_stride=8)],
    roi_head=dict(
        type="RoIHead",
        input_channels=512 * 5,
        model_cfg=dict(
            CLASS_AGNOSTIC=True,
            SHARED_FC=[256, 256],
            CLS_FC=[256, 256],
            REG_FC=[256, 256],
            DP_RATIO=0.3,
            TARGET_CONFIG=dict(
                ROI_PER_IMAGE=128,
                FG_RATIO=0.5,
                SAMPLE_ROI_BY_EACH_CLASS=True,
                CLS_SCORE_TYPE="roi_iou",
                CLS_FG_THRESH=0.75,
                CLS_BG_THRESH=0.25,
                CLS_BG_THRESH_LO=0.1,
                HARD_BG_RATIO=0.8,
                REG_FG_THRESH=0.55,
            ),
            LOSS_CONFIG=dict(
                CLS_LOSS="BinaryCrossEntropy",
                REG_LOSS="L1",
                LOSS_WEIGHTS={"rcnn_cls_weight": 1.0, "rcnn_reg_weight": 1.0,
                              "code_weights": [1.0] * 7},
            ),
        ),
        code_size=7,
    ),
    NMS_POST_MAXSIZE=500,
    num_point=5,
    freeze=True,
)

assigner = dict(tasks=tasks)
assigner = dict(target_assigner=target_assigner, out_size_factor=8, dense_reg=1,
                gaussian_overlap=0.1, max_objs=500, min_radius=2)
train_cfg = dict(assigner=assigner)

test_cfg = dict(
    post_center_limit_range=[-80, -80, -10.0, 80, 80, 10.0],
    max_per_img=4096,
    nms=dict(use_rotate_nms=True, use_multi_class_nms=False,
             nms_pre_max_size=4096, nms_post_max_size=500,
             nms_iou_threshold=0.7),
    score_threshold=0.1, pc_range=[-75.2, -75.2], out_size_factor=8,
    voxel_size=[0.1, 0.1],
)

voxel_generator = dict(range=[-75.2, -75.2, -2, 75.2, 75.2, 4],
                       voxel_size=[0.1, 0.1, 0.15], max_points_in_voxel=5,
                       max_voxel_num=150000, distillation=False)

optimizer_config = dict(grad_clip=dict(max_norm=35, norm_type=2))
optimizer = dict(type="adam", amsgrad=0.0, wd=0.01, fixed_wd=True, moving_average=False)
lr_config = dict(type="one_cycle", lr_max=0.003, moms=[0.95, 0.85], div_factor=10.0,
                 pct_start=0.4)
# the reference's data layer (sparse2dense_tpu/zoo.py: _waymo_db_sampler,
# _pipeline, _data): the records' paths are the reference's, relative to the
# directory training runs in
dataset_type = "WaymoDataset"
nsweeps = 1
data_root = "../data/waymo"
db_sampler = dict(
    type="GT-AUG",
    enable=False,
    db_info_path="../data/waymo/dbinfos_train_1sweeps_withvelo.pkl",
    sample_groups=[dict(VEHICLE=15), dict(PEDESTRIAN=10), dict(CYCLIST=10)],
    db_prep_steps=[
        dict(filter_by_min_num_points=dict(VEHICLE=5, PEDESTRIAN=5, CYCLIST=5)),
        dict(filter_by_difficulty=[-1]),
    ],
    global_random_rotation_range_per_object=[0, 0],
    rate=1.0,
)
train_preprocessor = dict(
    mode="train",
    shuffle_points=True,
    global_rot_noise=[-0.78539816, 0.78539816],
    global_scale_noise=[0.95, 1.05],
    db_sampler=db_sampler,
    class_names=class_names,
    distillation=False,
)
val_preprocessor = dict(mode="val", shuffle_points=False, distillation=False)
train_pipeline = [
    dict(type="LoadPointCloudFromFile", dataset=dataset_type),
    dict(type="LoadPointCloudAnnotations", with_bbox=True),
    dict(type="Preprocess", cfg=train_preprocessor),
    dict(type="Voxelization", cfg=voxel_generator),
    dict(type="AssignLabel", cfg=assigner),
    dict(type="Reformat"),
]
test_pipeline = [
    dict(type="LoadPointCloudFromFile", dataset=dataset_type),
    dict(type="LoadPointCloudAnnotations", with_bbox=True),
    dict(type="Preprocess", cfg=val_preprocessor),
    dict(type="Voxelization", cfg=voxel_generator),
    dict(type="AssignLabel", cfg=assigner),
    dict(type="Reformat"),
]
train_anno = "../data/waymo/infos_train_01sweeps_filter_zero_gt.pkl"
val_anno = "../data/waymo/infos_val_01sweeps_filter_zero_gt.pkl"
test_anno = "../data/waymo/infos_test_01sweeps_filter_zero_gt.pkl"
data = dict(
    samples_per_gpu=6,
    workers_per_gpu=6,
    train=dict(
        type=dataset_type,
        root_path=data_root,
        info_path=train_anno,
        ann_file=train_anno,
        nsweeps=nsweeps,
        class_names=class_names,
        pipeline=train_pipeline,
        load_interval=1,
    ),
    val=dict(
        type=dataset_type,
        root_path=data_root,
        info_path=val_anno,
        test_mode=True,
        ann_file=val_anno,
        nsweeps=nsweeps,
        class_names=class_names,
        pipeline=test_pipeline,
    ),
    test=dict(
        type=dataset_type,
        root_path=data_root,
        info_path=test_anno,
        ann_file=test_anno,
        nsweeps=nsweeps,
        class_names=class_names,
        pipeline=test_pipeline,
        test_mode=True,
    ),
)
checkpoint_config = dict(interval=1)
log_config = dict(interval=5, hooks=[dict(type="TextLoggerHook")])
total_epochs = 6
log_level = "INFO"
work_dir = None
load_from = None
resume_from = None
workflow = [("train", 1)]
distillation = False
