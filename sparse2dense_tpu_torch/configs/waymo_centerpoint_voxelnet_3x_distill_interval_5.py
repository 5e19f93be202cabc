# CenterPoint-VoxelNet Sparse2Dense on Waymo: the flagship configuration,
# the dense VoxelNet teacher (model) distilling into the KD_VoxelNet +
# S2D_RPN student (S_model). Copied from the reference zoo entry
# (sparse2dense_tpu/zoo.py: _voxelnet_model, the train_cfg, test_cfg,
# voxel_generator and _runtime of waymo_voxelnet "3x_distill_interval_5").
# The recipe's teacher checkpoint (epoch_30.pth of the dense stage) is not in
# the repository: teacher and student take seeded random weights.
import itertools

tasks = [dict(num_class=3, class_names=["VEHICLE", "PEDESTRIAN", "CYCLIST"])]
class_names = list(itertools.chain(*[t["class_names"] for t in tasks]))


def _voxelnet(student):
    return dict(
        type="KD_VoxelNet" if student else "VoxelNet",
        pretrained=None,
        reader=dict(type="VoxelFeatureExtractorV3", num_input_features=5),
        # windowed sparse engine for conv1 and conv2_down, masked dense bf16
        # 3D convs from conv2 on; the conv2 row budget covers the dilated
        # active set of a 150k-voxel Waymo frame
        backbone=dict(type="SpMiddleResNetFHD", num_input_features=5,
                      ds_factor=8, engine="window", dense_from_stage=1,
                      dense_compute_dtype="bfloat16",
                      stage_budgets=(320000, 210000, 90000, 48000)),
        neck=dict(
            type="S2D_RPN" if student else "RPN",
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


model = _voxelnet(student=False)
S_model = _voxelnet(student=True)

target_assigner = dict(tasks=tasks)
assigner = dict(target_assigner=target_assigner, out_size_factor=8, dense_reg=1,
                gaussian_overlap=0.1, max_objs=500, min_radius=2)
train_cfg = dict(assigner=assigner)

test_cfg = dict(
    post_center_limit_range=[-80, -80, -10.0, 80, 80, 10.0],
    nms=dict(use_rotate_nms=True, use_multi_class_nms=False,
             nms_pre_max_size=4096, nms_post_max_size=500,
             nms_iou_threshold=0.7),
    score_threshold=0.1, pc_range=[-75.2, -75.2], out_size_factor=8,
    voxel_size=[0.1, 0.1],
)

voxel_generator = dict(range=[-75.2, -75.2, -2, 75.2, 75.2, 4],
                       voxel_size=[0.1, 0.1, 0.15], max_points_in_voxel=5,
                       max_voxel_num=150000)

optimizer_config = dict(grad_clip=dict(max_norm=35, norm_type=2))
optimizer = dict(type="adam", amsgrad=0.0, wd=0.01, fixed_wd=True, moving_average=False)
lr_config = dict(type="one_cycle", lr_max=0.003, moms=[0.95, 0.85], div_factor=10.0,
                 pct_start=0.3)
total_epochs = 30   # the recipe's data block (not ported) has samples_per_gpu=3
distillation = True
