# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: caffe.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




# anakin_tpu_torch: a pool of the port's own, so that this copy and the
# JAX package's (the same file name and package) load in one process
_POOL = _descriptor_pool.DescriptorPool()
DESCRIPTOR = _POOL.AddSerializedFile(b'\n\x0b\x63\x61\x66\x66\x65.proto\x12\x0c\x61nakin_caffe\"\x1c\n\tBlobShape\x12\x0f\n\x03\x64im\x18\x01 \x03(\x03\x42\x02\x10\x01\"\xa1\x01\n\tBlobProto\x12&\n\x05shape\x18\x07 \x01(\x0b\x32\x17.anakin_caffe.BlobShape\x12\x10\n\x04\x64\x61ta\x18\x05 \x03(\x02\x42\x02\x10\x01\x12\x10\n\x04\x64iff\x18\x06 \x03(\x02\x42\x02\x10\x01\x12\x0e\n\x03num\x18\x01 \x01(\x05:\x01\x30\x12\x13\n\x08\x63hannels\x18\x02 \x01(\x05:\x01\x30\x12\x11\n\x06height\x18\x03 \x01(\x05:\x01\x30\x12\x10\n\x05width\x18\x04 \x01(\x05:\x01\x30\"2\n\x0cNetStateRule\x12\"\n\x05phase\x18\x01 \x01(\x0e\x32\x13.anakin_caffe.Phase\"|\n\x0f\x46illerParameter\x12\x16\n\x04type\x18\x01 \x01(\t:\x08\x63onstant\x12\x10\n\x05value\x18\x02 \x01(\x02:\x01\x30\x12\x0e\n\x03min\x18\x03 \x01(\x02:\x01\x30\x12\x0e\n\x03max\x18\x04 \x01(\x02:\x01\x31\x12\x0f\n\x04mean\x18\x05 \x01(\x02:\x01\x30\x12\x0e\n\x03std\x18\x06 \x01(\x02:\x01\x31\"\x99\x01\n\x0cNetParameter\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\r\n\x05input\x18\x03 \x03(\t\x12,\n\x0binput_shape\x18\x08 \x03(\x0b\x32\x17.anakin_caffe.BlobShape\x12\x11\n\tinput_dim\x18\x04 \x03(\x05\x12+\n\x05layer\x18\x64 \x03(\x0b\x32\x1c.anakin_caffe.LayerParameter\"D\n\tParamSpec\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x12\n\x07lr_mult\x18\x03 \x01(\x02:\x01\x31\x12\x15\n\ndecay_mult\x18\x04 \x01(\x02:\x01\x31\"\x85\x0f\n\x0eLayerParameter\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0c\n\x04type\x18\x02 \x01(\t\x12\x0e\n\x06\x62ottom\x18\x03 \x03(\t\x12\x0b\n\x03top\x18\x04 \x03(\t\x12\"\n\x05phase\x18\n \x01(\x0e\x32\x13.anakin_caffe.Phase\x12\x13\n\x0bloss_weight\x18\x05 \x03(\x02\x12&\n\x05param\x18\x06 \x03(\x0b\x32\x17.anakin_caffe.ParamSpec\x12&\n\x05\x62lobs\x18\x07 \x03(\x0b\x32\x17.anakin_caffe.BlobProto\x12+\n\x07include\x18\x08 \x03(\x0b\x32\x1a.anakin_caffe.NetStateRule\x12+\n\x07\x65xclude\x18\t \x03(\x0b\x32\x1a.anakin_caffe.NetStateRule\x12\x33\n\x0c\x61rgmax_param\x18g \x01(\x0b\x32\x1d.anakin_caffe.ArgMaxParameter\x12;\n\x10\x62\x61tch_norm_param\x18\x8b\x01 \x01(\x0b\x32 .anakin_caffe.BatchNormParameter\x12\x30\n\nbias_param\x18\x8d\x01 \x01(\x0b\x32\x1b.anakin_caffe.BiasParameter\x12\x33\n\x0c\x63oncat_param\x18h \x01(\x0b\x32\x1d.anakin_caffe.ConcatParameter\x12=\n\x11\x63onvolution_param\x18j \x01(\x0b\x32\".anakin_caffe.ConvolutionParameter\x12\x30\n\ncrop_param\x18\x90\x01 \x01(\x0b\x32\x1b.anakin_caffe.CropParameter\x12\x35\n\rdropout_param\x18l \x01(\x0b\x32\x1e.anakin_caffe.DropoutParameter\x12\x35\n\reltwise_param\x18n \x01(\x0b\x32\x1e.anakin_caffe.EltwiseParameter\x12.\n\telu_param\x18\x8c\x01 \x01(\x0b\x32\x1a.anakin_caffe.ELUParameter\x12-\n\texp_param\x18o \x01(\x0b\x32\x1a.anakin_caffe.ExpParameter\x12\x36\n\rflatten_param\x18\x87\x01 \x01(\x0b\x32\x1e.anakin_caffe.FlattenParameter\x12@\n\x13inner_product_param\x18u \x01(\x0b\x32#.anakin_caffe.InnerProductParameter\x12\x32\n\x0binput_param\x18\x8f\x01 \x01(\x0b\x32\x1c.anakin_caffe.InputParameter\x12.\n\tlog_param\x18\x86\x01 \x01(\x0b\x32\x1a.anakin_caffe.LogParameter\x12-\n\tlrn_param\x18v \x01(\x0b\x32\x1a.anakin_caffe.LRNParameter\x12-\n\tmvn_param\x18x \x01(\x0b\x32\x1a.anakin_caffe.MVNParameter\x12\x35\n\rpooling_param\x18y \x01(\x0b\x32\x1e.anakin_caffe.PoolingParameter\x12\x31\n\x0bpower_param\x18z \x01(\x0b\x32\x1c.anakin_caffe.PowerParameter\x12\x32\n\x0bprelu_param\x18\x83\x01 \x01(\x0b\x32\x1c.anakin_caffe.PReLUParameter\x12:\n\x0freduction_param\x18\x88\x01 \x01(\x0b\x32 .anakin_caffe.ReductionParameter\x12/\n\nrelu_param\x18{ \x01(\x0b\x32\x1b.anakin_caffe.ReLUParameter\x12\x36\n\rreshape_param\x18\x85\x01 \x01(\x0b\x32\x1e.anakin_caffe.ReshapeParameter\x12\x32\n\x0bscale_param\x18\x8e\x01 \x01(\x0b\x32\x1c.anakin_caffe.ScaleParameter\x12\x31\n\x0bslice_param\x18~ \x01(\x0b\x32\x1c.anakin_caffe.SliceParameter\x12\x35\n\rsoftmax_param\x18} \x01(\x0b\x32\x1e.anakin_caffe.SoftmaxParameter\x12\x30\n\ntile_param\x18\x8a\x01 \x01(\x0b\x32\x1b.anakin_caffe.TileParameter\x12\x36\n\rpermute_param\x18\xca\x01 \x01(\x0b\x32\x1e.anakin_caffe.PermuteParameter\x12\x35\n\nnorm_param\x18\xce\x01 \x01(\x0b\x32 .anakin_caffe.NormalizeParameter\x12\x39\n\x0fprior_box_param\x18\xcb\x01 \x01(\x0b\x32\x1f.anakin_caffe.PriorBoxParameter\x12G\n\x16\x64\x65tection_output_param\x18\xcc\x01 \x01(\x0b\x32&.anakin_caffe.DetectionOutputParameter\"\x80\x03\n\x14\x43onvolutionParameter\x12\x12\n\nnum_output\x18\x01 \x01(\r\x12\x17\n\tbias_term\x18\x02 \x01(\x08:\x04true\x12\x0b\n\x03pad\x18\x03 \x03(\r\x12\x13\n\x0bkernel_size\x18\x04 \x03(\r\x12\x10\n\x05group\x18\x05 \x01(\r:\x01\x31\x12\x0e\n\x06stride\x18\x06 \x03(\r\x12\x34\n\rweight_filler\x18\x07 \x01(\x0b\x32\x1d.anakin_caffe.FillerParameter\x12\x32\n\x0b\x62ias_filler\x18\x08 \x01(\x0b\x32\x1d.anakin_caffe.FillerParameter\x12\x10\n\x05pad_h\x18\t \x01(\r:\x01\x30\x12\x10\n\x05pad_w\x18\n \x01(\r:\x01\x30\x12\x10\n\x08kernel_h\x18\x0b \x01(\r\x12\x10\n\x08kernel_w\x18\x0c \x01(\r\x12\x10\n\x08stride_h\x18\r \x01(\r\x12\x10\n\x08stride_w\x18\x0e \x01(\r\x12\x0f\n\x04\x61xis\x18\x10 \x01(\x05:\x01\x31\x12\x10\n\x08\x64ilation\x18\x12 \x03(\r\"\xa9\x03\n\x10PoolingParameter\x12<\n\x04pool\x18\x01 \x01(\x0e\x32).anakin_caffe.PoolingParameter.PoolMethod:\x03MAX\x12\x13\n\x0bkernel_size\x18\x02 \x01(\r\x12\x11\n\x06stride\x18\x03 \x01(\r:\x01\x31\x12\x0e\n\x03pad\x18\x04 \x01(\r:\x01\x30\x12\x10\n\x08kernel_h\x18\x05 \x01(\r\x12\x10\n\x08kernel_w\x18\x06 \x01(\r\x12\x10\n\x08stride_h\x18\x07 \x01(\r\x12\x10\n\x08stride_w\x18\x08 \x01(\r\x12\x10\n\x05pad_h\x18\t \x01(\r:\x01\x30\x12\x10\n\x05pad_w\x18\n \x01(\r:\x01\x30\x12\x1d\n\x0eglobal_pooling\x18\x0c \x01(\x08:\x05\x66\x61lse\x12\x42\n\nround_mode\x18\r \x01(\x0e\x32(.anakin_caffe.PoolingParameter.RoundMode:\x04\x43\x45IL\".\n\nPoolMethod\x12\x07\n\x03MAX\x10\x00\x12\x07\n\x03\x41VE\x10\x01\x12\x0e\n\nSTOCHASTIC\x10\x02\" \n\tRoundMode\x12\x08\n\x04\x43\x45IL\x10\x00\x12\t\n\x05\x46LOOR\x10\x01\"\xd9\x01\n\x15InnerProductParameter\x12\x12\n\nnum_output\x18\x01 \x01(\r\x12\x17\n\tbias_term\x18\x02 \x01(\x08:\x04true\x12\x34\n\rweight_filler\x18\x03 \x01(\x0b\x32\x1d.anakin_caffe.FillerParameter\x12\x32\n\x0b\x62ias_filler\x18\x04 \x01(\x0b\x32\x1d.anakin_caffe.FillerParameter\x12\x0f\n\x04\x61xis\x18\x05 \x01(\x05:\x01\x31\x12\x18\n\ttranspose\x18\x06 \x01(\x08:\x05\x66\x61lse\"\xdd\x01\n\x0cLRNParameter\x12\x15\n\nlocal_size\x18\x01 \x01(\r:\x01\x35\x12\x10\n\x05\x61lpha\x18\x02 \x01(\x02:\x01\x31\x12\x12\n\x04\x62\x65ta\x18\x03 \x01(\x02:\x04\x30.75\x12K\n\x0bnorm_region\x18\x04 \x01(\x0e\x32%.anakin_caffe.LRNParameter.NormRegion:\x0f\x41\x43ROSS_CHANNELS\x12\x0c\n\x01k\x18\x05 \x01(\x02:\x01\x31\"5\n\nNormRegion\x12\x13\n\x0f\x41\x43ROSS_CHANNELS\x10\x00\x12\x12\n\x0eWITHIN_CHANNEL\x10\x01\"j\n\x12\x42\x61tchNormParameter\x12\x18\n\x10use_global_stats\x18\x01 \x01(\x08\x12&\n\x17moving_average_fraction\x18\x02 \x01(\x02:\x05\x30.999\x12\x12\n\x03\x65ps\x18\x03 \x01(\x02:\x05\x31\x65-05\"\xb3\x01\n\x0eScaleParameter\x12\x0f\n\x04\x61xis\x18\x01 \x01(\x05:\x01\x31\x12\x13\n\x08num_axes\x18\x02 \x01(\x05:\x01\x31\x12-\n\x06\x66iller\x18\x03 \x01(\x0b\x32\x1d.anakin_caffe.FillerParameter\x12\x18\n\tbias_term\x18\x04 \x01(\x08:\x05\x66\x61lse\x12\x32\n\x0b\x62ias_filler\x18\x05 \x01(\x0b\x32\x1d.anakin_caffe.FillerParameter\"d\n\rBiasParameter\x12\x0f\n\x04\x61xis\x18\x01 \x01(\x05:\x01\x31\x12\x13\n\x08num_axes\x18\x02 \x01(\x05:\x01\x31\x12-\n\x06\x66iller\x18\x03 \x01(\x0b\x32\x1d.anakin_caffe.FillerParameter\"\xac\x01\n\x10\x45ltwiseParameter\x12@\n\toperation\x18\x01 \x01(\x0e\x32(.anakin_caffe.EltwiseParameter.EltwiseOp:\x03SUM\x12\r\n\x05\x63oeff\x18\x02 \x03(\x02\x12\x1e\n\x10stable_prod_grad\x18\x03 \x01(\x08:\x04true\"\'\n\tEltwiseOp\x12\x08\n\x04PROD\x10\x00\x12\x07\n\x03SUM\x10\x01\x12\x07\n\x03MAX\x10\x02\"9\n\x0f\x43oncatParameter\x12\x15\n\nconcat_dim\x18\x01 \x01(\r:\x01\x31\x12\x0f\n\x04\x61xis\x18\x02 \x01(\x05:\x01\x31\"#\n\x10SoftmaxParameter\x12\x0f\n\x04\x61xis\x18\x02 \x01(\x05:\x01\x31\".\n\x10\x44ropoutParameter\x12\x1a\n\rdropout_ratio\x18\x01 \x01(\x02:\x03\x30.5\"a\n\x10ReshapeParameter\x12&\n\x05shape\x18\x01 \x01(\x0b\x32\x17.anakin_caffe.BlobShape\x12\x0f\n\x04\x61xis\x18\x02 \x01(\x05:\x01\x30\x12\x14\n\x08num_axes\x18\x03 \x01(\x05:\x02-1\"9\n\x10\x46lattenParameter\x12\x0f\n\x04\x61xis\x18\x01 \x01(\x05:\x01\x31\x12\x14\n\x08\x65nd_axis\x18\x02 \x01(\x05:\x02-1\"F\n\x0ePowerParameter\x12\x10\n\x05power\x18\x01 \x01(\x02:\x01\x31\x12\x10\n\x05scale\x18\x02 \x01(\x02:\x01\x31\x12\x10\n\x05shift\x18\x03 \x01(\x02:\x01\x30\"D\n\x0c\x45xpParameter\x12\x10\n\x04\x62\x61se\x18\x01 \x01(\x02:\x02-1\x12\x10\n\x05scale\x18\x02 \x01(\x02:\x01\x31\x12\x10\n\x05shift\x18\x03 \x01(\x02:\x01\x30\"D\n\x0cLogParameter\x12\x10\n\x04\x62\x61se\x18\x01 \x01(\x02:\x02-1\x12\x10\n\x05scale\x18\x02 \x01(\x02:\x01\x31\x12\x10\n\x05shift\x18\x03 \x01(\x02:\x01\x30\"*\n\rReLUParameter\x12\x19\n\x0enegative_slope\x18\x01 \x01(\x02:\x01\x30\" \n\x0c\x45LUParameter\x12\x10\n\x05\x61lpha\x18\x01 \x01(\x02:\x01\x31\"^\n\x0ePReLUParameter\x12-\n\x06\x66iller\x18\x01 \x01(\x0b\x32\x1d.anakin_caffe.FillerParameter\x12\x1d\n\x0e\x63hannel_shared\x18\x02 \x01(\x08:\x05\x66\x61lse\"L\n\x0eSliceParameter\x12\x14\n\tslice_dim\x18\x01 \x01(\r:\x01\x31\x12\x13\n\x0bslice_point\x18\x02 \x03(\r\x12\x0f\n\x04\x61xis\x18\x03 \x01(\x05:\x01\x31\"8\n\x0eInputParameter\x12&\n\x05shape\x18\x01 \x03(\x0b\x32\x17.anakin_caffe.BlobShape\"0\n\rCropParameter\x12\x0f\n\x04\x61xis\x18\x01 \x01(\x05:\x01\x32\x12\x0e\n\x06offset\x18\x02 \x03(\r\"d\n\x0cMVNParameter\x12 \n\x12normalize_variance\x18\x01 \x01(\x08:\x04true\x12\x1e\n\x0f\x61\x63ross_channels\x18\x02 \x01(\x08:\x05\x66\x61lse\x12\x12\n\x03\x65ps\x18\x03 \x01(\x02:\x05\x31\x65-09\"\xb4\x01\n\x12ReductionParameter\x12\x44\n\toperation\x18\x01 \x01(\x0e\x32,.anakin_caffe.ReductionParameter.ReductionOp:\x03SUM\x12\x0f\n\x04\x61xis\x18\x02 \x01(\x05:\x01\x30\x12\x10\n\x05\x63oeff\x18\x03 \x01(\x02:\x01\x31\"5\n\x0bReductionOp\x12\x07\n\x03SUM\x10\x01\x12\x08\n\x04\x41SUM\x10\x02\x12\t\n\x05SUMSQ\x10\x03\x12\x08\n\x04MEAN\x10\x04\"M\n\x0f\x41rgMaxParameter\x12\x1a\n\x0bout_max_val\x18\x01 \x01(\x08:\x05\x66\x61lse\x12\x10\n\x05top_k\x18\x02 \x01(\r:\x01\x31\x12\x0c\n\x04\x61xis\x18\x03 \x01(\x05\"/\n\rTileParameter\x12\x0f\n\x04\x61xis\x18\x01 \x01(\x05:\x01\x31\x12\r\n\x05tiles\x18\x02 \x01(\x05\"!\n\x10PermuteParameter\x12\r\n\x05order\x18\x01 \x03(\r\"\x99\x01\n\x12NormalizeParameter\x12\x1c\n\x0e\x61\x63ross_spatial\x18\x01 \x01(\x08:\x04true\x12\x33\n\x0cscale_filler\x18\x02 \x01(\x0b\x32\x1d.anakin_caffe.FillerParameter\x12\x1c\n\x0e\x63hannel_shared\x18\x03 \x01(\x08:\x04true\x12\x12\n\x03\x65ps\x18\x04 \x01(\x02:\x05\x31\x65-10\"\xfb\x01\n\x11PriorBoxParameter\x12\x10\n\x08min_size\x18\x01 \x03(\x02\x12\x10\n\x08max_size\x18\x02 \x03(\x02\x12\x14\n\x0c\x61spect_ratio\x18\x03 \x03(\x02\x12\x12\n\x04\x66lip\x18\x04 \x01(\x08:\x04true\x12\x13\n\x04\x63lip\x18\x05 \x01(\x08:\x05\x66\x61lse\x12\x10\n\x08variance\x18\x06 \x03(\x02\x12\x10\n\x08img_size\x18\x07 \x01(\r\x12\r\n\x05img_h\x18\x08 \x01(\r\x12\r\n\x05img_w\x18\t \x01(\r\x12\x0c\n\x04step\x18\n \x01(\x02\x12\x0e\n\x06step_h\x18\x0b \x01(\x02\x12\x0e\n\x06step_w\x18\x0c \x01(\x02\x12\x13\n\x06offset\x18\r \x01(\x02:\x03\x30.5\"[\n\x1eNonMaximumSuppressionParameter\x12\x1a\n\rnms_threshold\x18\x01 \x01(\x02:\x03\x30.3\x12\r\n\x05top_k\x18\x02 \x01(\x05\x12\x0e\n\x03\x65ta\x18\x03 \x01(\x02:\x01\x31\"\x95\x03\n\x18\x44\x65tectionOutputParameter\x12\x13\n\x0bnum_classes\x18\x01 \x01(\r\x12\x1c\n\x0eshare_location\x18\x02 \x01(\x08:\x04true\x12\x1e\n\x13\x62\x61\x63kground_label_id\x18\x03 \x01(\x05:\x01\x30\x12?\n\tnms_param\x18\x04 \x01(\x0b\x32,.anakin_caffe.NonMaximumSuppressionParameter\x12J\n\tcode_type\x18\x06 \x01(\x0e\x32/.anakin_caffe.DetectionOutputParameter.CodeType:\x06\x43ORNER\x12\x16\n\nkeep_top_k\x18\x07 \x01(\x05:\x02-1\x12)\n\x1avariance_encoded_in_target\x18\x08 \x01(\x08:\x05\x66\x61lse\x12\x1c\n\x14\x63onfidence_threshold\x18\t \x01(\x02\"8\n\x08\x43odeType\x12\n\n\x06\x43ORNER\x10\x01\x12\x0f\n\x0b\x43\x45NTER_SIZE\x10\x02\x12\x0f\n\x0b\x43ORNER_SIZE\x10\x03*\x1c\n\x05Phase\x12\t\n\x05TRAIN\x10\x00\x12\x08\n\x04TEST\x10\x01')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'caffe_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _BLOBSHAPE.fields_by_name['dim']._options = None
  _BLOBSHAPE.fields_by_name['dim']._serialized_options = b'\020\001'
  _BLOBPROTO.fields_by_name['data']._options = None
  _BLOBPROTO.fields_by_name['data']._serialized_options = b'\020\001'
  _BLOBPROTO.fields_by_name['diff']._options = None
  _BLOBPROTO.fields_by_name['diff']._serialized_options = b'\020\001'
  _PHASE._serialized_start=6614
  _PHASE._serialized_end=6642
  _BLOBSHAPE._serialized_start=29
  _BLOBSHAPE._serialized_end=57
  _BLOBPROTO._serialized_start=60
  _BLOBPROTO._serialized_end=221
  _NETSTATERULE._serialized_start=223
  _NETSTATERULE._serialized_end=273
  _FILLERPARAMETER._serialized_start=275
  _FILLERPARAMETER._serialized_end=399
  _NETPARAMETER._serialized_start=402
  _NETPARAMETER._serialized_end=555
  _PARAMSPEC._serialized_start=557
  _PARAMSPEC._serialized_end=625
  _LAYERPARAMETER._serialized_start=628
  _LAYERPARAMETER._serialized_end=2553
  _CONVOLUTIONPARAMETER._serialized_start=2556
  _CONVOLUTIONPARAMETER._serialized_end=2940
  _POOLINGPARAMETER._serialized_start=2943
  _POOLINGPARAMETER._serialized_end=3368
  _POOLINGPARAMETER_POOLMETHOD._serialized_start=3288
  _POOLINGPARAMETER_POOLMETHOD._serialized_end=3334
  _POOLINGPARAMETER_ROUNDMODE._serialized_start=3336
  _POOLINGPARAMETER_ROUNDMODE._serialized_end=3368
  _INNERPRODUCTPARAMETER._serialized_start=3371
  _INNERPRODUCTPARAMETER._serialized_end=3588
  _LRNPARAMETER._serialized_start=3591
  _LRNPARAMETER._serialized_end=3812
  _LRNPARAMETER_NORMREGION._serialized_start=3759
  _LRNPARAMETER_NORMREGION._serialized_end=3812
  _BATCHNORMPARAMETER._serialized_start=3814
  _BATCHNORMPARAMETER._serialized_end=3920
  _SCALEPARAMETER._serialized_start=3923
  _SCALEPARAMETER._serialized_end=4102
  _BIASPARAMETER._serialized_start=4104
  _BIASPARAMETER._serialized_end=4204
  _ELTWISEPARAMETER._serialized_start=4207
  _ELTWISEPARAMETER._serialized_end=4379
  _ELTWISEPARAMETER_ELTWISEOP._serialized_start=4340
  _ELTWISEPARAMETER_ELTWISEOP._serialized_end=4379
  _CONCATPARAMETER._serialized_start=4381
  _CONCATPARAMETER._serialized_end=4438
  _SOFTMAXPARAMETER._serialized_start=4440
  _SOFTMAXPARAMETER._serialized_end=4475
  _DROPOUTPARAMETER._serialized_start=4477
  _DROPOUTPARAMETER._serialized_end=4523
  _RESHAPEPARAMETER._serialized_start=4525
  _RESHAPEPARAMETER._serialized_end=4622
  _FLATTENPARAMETER._serialized_start=4624
  _FLATTENPARAMETER._serialized_end=4681
  _POWERPARAMETER._serialized_start=4683
  _POWERPARAMETER._serialized_end=4753
  _EXPPARAMETER._serialized_start=4755
  _EXPPARAMETER._serialized_end=4823
  _LOGPARAMETER._serialized_start=4825
  _LOGPARAMETER._serialized_end=4893
  _RELUPARAMETER._serialized_start=4895
  _RELUPARAMETER._serialized_end=4937
  _ELUPARAMETER._serialized_start=4939
  _ELUPARAMETER._serialized_end=4971
  _PRELUPARAMETER._serialized_start=4973
  _PRELUPARAMETER._serialized_end=5067
  _SLICEPARAMETER._serialized_start=5069
  _SLICEPARAMETER._serialized_end=5145
  _INPUTPARAMETER._serialized_start=5147
  _INPUTPARAMETER._serialized_end=5203
  _CROPPARAMETER._serialized_start=5205
  _CROPPARAMETER._serialized_end=5253
  _MVNPARAMETER._serialized_start=5255
  _MVNPARAMETER._serialized_end=5355
  _REDUCTIONPARAMETER._serialized_start=5358
  _REDUCTIONPARAMETER._serialized_end=5538
  _REDUCTIONPARAMETER_REDUCTIONOP._serialized_start=5485
  _REDUCTIONPARAMETER_REDUCTIONOP._serialized_end=5538
  _ARGMAXPARAMETER._serialized_start=5540
  _ARGMAXPARAMETER._serialized_end=5617
  _TILEPARAMETER._serialized_start=5619
  _TILEPARAMETER._serialized_end=5666
  _PERMUTEPARAMETER._serialized_start=5668
  _PERMUTEPARAMETER._serialized_end=5701
  _NORMALIZEPARAMETER._serialized_start=5704
  _NORMALIZEPARAMETER._serialized_end=5857
  _PRIORBOXPARAMETER._serialized_start=5860
  _PRIORBOXPARAMETER._serialized_end=6111
  _NONMAXIMUMSUPPRESSIONPARAMETER._serialized_start=6113
  _NONMAXIMUMSUPPRESSIONPARAMETER._serialized_end=6204
  _DETECTIONOUTPUTPARAMETER._serialized_start=6207
  _DETECTIONOUTPUTPARAMETER._serialized_end=6612
  _DETECTIONOUTPUTPARAMETER_CODETYPE._serialized_start=6556
  _DETECTIONOUTPUTPARAMETER_CODETYPE._serialized_end=6612
# @@protoc_insertion_point(module_scope)
