# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: dragonfly.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0f\x64ragonfly.proto\x12\rdragonfly2tpu\"\x07\n\x05\x45mpty\",\n\x0bNetworkInfo\x12\x0b\n\x03idc\x18\x01 \x01(\t\x12\x10\n\x08location\x18\x02 \x01(\t\"\xe4\x01\n\x08WireHost\x12\n\n\x02id\x18\x01 \x01(\t\x12\x10\n\x08hostname\x18\x02 \x01(\t\x12\n\n\x02ip\x18\x03 \x01(\t\x12\x0c\n\x04port\x18\x04 \x01(\x05\x12\x15\n\rdownload_port\x18\x05 \x01(\x05\x12\x0c\n\x04type\x18\x06 \x01(\x05\x12\x1f\n\x17\x63oncurrent_upload_limit\x18\x07 \x01(\x05\x12+\n\x07network\x18\x08 \x01(\x0b\x32\x1a.dragonfly2tpu.NetworkInfo\x12\x13\n\x0b\x63pu_percent\x18\t \x01(\x01\x12\x18\n\x10mem_used_percent\x18\n \x01(\x01\"V\n\x13\x41nnounceHostRequest\x12%\n\x04host\x18\x01 \x01(\x0b\x32\x17.dragonfly2tpu.WireHost\x12\x18\n\x10protocol_version\x18\x02 \x01(\x05\"`\n\x0cProtocolInfo\x12\x0f\n\x07version\x18\x01 \x01(\x05\x12\x15\n\rmin_supported\x18\x02 \x01(\x05\x12\x12\n\nnegotiated\x18\x03 \x01(\x05\x12\x14\n\x0c\x63\x61pabilities\x18\x04 \x03(\t\"E\n\x14\x41nnounceHostResponse\x12-\n\x08protocol\x18\x01 \x01(\x0b\x32\x1b.dragonfly2tpu.ProtocolInfo\"\x89\x01\n\x13RegisterPeerRequest\x12\x0f\n\x07host_id\x18\x01 \x01(\t\x12\x0b\n\x03url\x18\x02 \x01(\t\x12\x0f\n\x07peer_id\x18\x03 \x01(\t\x12\x0f\n\x07task_id\x18\x04 \x01(\t\x12\x0b\n\x03tag\x18\x05 \x01(\t\x12\x13\n\x0b\x61pplication\x18\x06 \x01(\t\x12\x10\n\x08priority\x18\x07 \x01(\x05\"D\n\nWireParent\x12\x0f\n\x07peer_id\x18\x01 \x01(\t\x12%\n\x04host\x18\x02 \x01(\x0b\x32\x17.dragonfly2tpu.WireHost\"\x82\x02\n\x14RegisterPeerResponse\x12\x0f\n\x07peer_id\x18\x01 \x01(\t\x12\x0f\n\x07task_id\x18\x02 \x01(\t\x12\x12\n\nsize_scope\x18\x03 \x01(\x05\x12\x14\n\x0c\x64irect_piece\x18\x04 \x01(\t\x12\x16\n\x0e\x63ontent_length\x18\x05 \x01(\x03\x12\x19\n\x11total_piece_count\x18\x06 \x01(\x05\x12\x12\n\npiece_size\x18\x07 \x01(\x05\x12\x1b\n\x13need_back_to_source\x18\x08 \x01(\x08\x12*\n\x07parents\x18\t \x03(\x0b\x32\x19.dragonfly2tpu.WireParent\x12\x0e\n\x06\x66\x61iled\x18\n \x01(\x08\"l\n\x12SetTaskInfoRequest\x12\x0f\n\x07peer_id\x18\x01 \x01(\t\x12\x16\n\x0e\x63ontent_length\x18\x02 \x01(\x03\x12\x19\n\x11total_piece_count\x18\x03 \x01(\x05\x12\x12\n\npiece_size\x18\x04 \x01(\x05\"Y\n\x10TaskInfoResponse\x12\x16\n\x0e\x63ontent_length\x18\x01 \x01(\x03\x12\x19\n\x11total_piece_count\x18\x02 \x01(\x05\x12\x12\n\npiece_size\x18\x03 \x01(\x05\"q\n\x1aReportPieceFinishedRequest\x12\x0f\n\x07peer_id\x18\x01 \x01(\t\x12\x0e\n\x06number\x18\x02 \x01(\x05\x12\x11\n\tparent_id\x18\x03 \x01(\t\x12\x0e\n\x06length\x18\x04 \x01(\x03\x12\x0f\n\x07\x63ost_ns\x18\x05 \x01(\x03\">\n\x18ReportPieceFailedRequest\x12\x0f\n\x07peer_id\x18\x01 \x01(\t\x12\x11\n\tparent_id\x18\x02 \x01(\t\"[\n\x10ScheduleResponse\x12\x1b\n\x13need_back_to_source\x18\x01 \x01(\x08\x12*\n\x07parents\x18\x02 \x03(\x0b\x32\x19.dragonfly2tpu.WireParent\"\x1e\n\x0bPeerRequest\x12\x0f\n\x07peer_id\x18\x01 \x01(\t\"7\n\x12\x44irectPieceRequest\x12\x0f\n\x07peer_id\x18\x01 \x01(\t\x12\x10\n\x08\x64\x61ta_b64\x18\x02 \x01(\t\"\x1e\n\x0bHostRequest\x12\x0f\n\x07host_id\x18\x01 \x01(\t\"C\n\x17SyncProbesStartResponse\x12(\n\x07targets\x18\x01 \x03(\x0b\x32\x17.dragonfly2tpu.WireHost\"+\n\x0bProbeResult\x12\x0c\n\x04\x64\x65st\x18\x01 \x01(\t\x12\x0e\n\x06rtt_ns\x18\x02 \x01(\x03\"Y\n\x19SyncProbesFinishedRequest\x12\x0f\n\x07host_id\x18\x01 \x01(\t\x12+\n\x07results\x18\x02 \x03(\x0b\x32\x1a.dragonfly2tpu.ProbeResult\"\xd7\x04\n\x13\x41nnouncePeerRequest\x12\x0b\n\x03seq\x18\x01 \x01(\x03\x12\x36\n\x08register\x18\x02 \x01(\x0b\x32\".dragonfly2tpu.RegisterPeerRequestH\x00\x12\x36\n\ttask_info\x18\x03 \x01(\x0b\x32!.dragonfly2tpu.SetTaskInfoRequestH\x00\x12\x43\n\x0epiece_finished\x18\x04 \x01(\x0b\x32).dragonfly2tpu.ReportPieceFinishedRequestH\x00\x12?\n\x0cpiece_failed\x18\x05 \x01(\x0b\x32\'.dragonfly2tpu.ReportPieceFailedRequestH\x00\x12\x33\n\rpeer_finished\x18\x06 \x01(\x0b\x32\x1a.dragonfly2tpu.PeerRequestH\x00\x12\x31\n\x0bpeer_failed\x18\x07 \x01(\x0b\x32\x1a.dragonfly2tpu.PeerRequestH\x00\x12\x34\n\x0e\x62\x61\x63k_to_source\x18\x08 \x01(\x0b\x32\x1a.dragonfly2tpu.PeerRequestH\x00\x12+\n\x05leave\x18\t \x01(\x0b\x32\x1a.dragonfly2tpu.PeerRequestH\x00\x12\x39\n\x0c\x64irect_piece\x18\n \x01(\x0b\x32!.dragonfly2tpu.DirectPieceRequestH\x00\x12,\n\x06resume\x18\x0b \x01(\x0b\x32\x1a.dragonfly2tpu.PeerRequestH\x00\x42\t\n\x07payload\"\xa6\x02\n\x14\x41nnouncePeerResponse\x12\x0b\n\x03seq\x18\x01 \x01(\x03\x12\r\n\x05\x65rror\x18\x02 \x01(\t\x12\x0c\n\x04\x63ode\x18\x03 \x01(\x05\x12\x0f\n\x07peer_id\x18\x04 \x01(\t\x12;\n\x0cregistration\x18\x05 \x01(\x0b\x32#.dragonfly2tpu.RegisterPeerResponseH\x00\x12\x33\n\x08schedule\x18\x06 \x01(\x0b\x32\x1f.dragonfly2tpu.ScheduleResponseH\x00\x12\x34\n\ttask_info\x18\x07 \x01(\x0b\x32\x1f.dragonfly2tpu.TaskInfoResponseH\x00\x12#\n\x03\x61\x63k\x18\x08 \x01(\x0b\x32\x14.dragonfly2tpu.EmptyH\x00\x42\x06\n\x04\x62ody\"w\n\nTrainChunk\x12\n\n\x02ip\x18\x01 \x01(\t\x12\x10\n\x08hostname\x18\x02 \x01(\t\x12\x14\n\x0cscheduler_id\x18\x03 \x01(\t\x12\x0c\n\x04kind\x18\x04 \x01(\t\x12\x0c\n\x04name\x18\x05 \x01(\t\x12\x0b\n\x03seq\x18\x06 \x01(\x03\x12\x0c\n\x04\x64\x61ta\x18\x07 \x01(\x0c\"\x19\n\nTrainReply\x12\x0b\n\x03run\x18\x01 \x01(\t\"\x1f\n\x10RunStatusRequest\x12\x0b\n\x03key\x18\x01 \x01(\t\"\x8e\x01\n\x0eRunStatusReply\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\x0c\n\x04\x64one\x18\x02 \x01(\x08\x12\r\n\x05\x65rror\x18\x03 \x01(\t\x12\x15\n\rdownload_rows\x18\x04 \x01(\x03\x12\x15\n\rtopology_rows\x18\x05 \x01(\x03\x12\x0e\n\x06models\x18\x06 \x03(\t\x12\x14\n\x0cmetrics_json\x18\x07 \x01(\t\"\x82\x01\n\tWireModel\x12\n\n\x02id\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x0c\n\x04type\x18\x03 \x01(\t\x12\x0f\n\x07version\x18\x04 \x01(\x05\x12\x14\n\x0cscheduler_id\x18\x05 \x01(\t\x12\r\n\x05state\x18\x06 \x01(\t\x12\x17\n\x0f\x65valuation_json\x18\x07 \x01(\t\"q\n\x12\x43reateModelRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0c\n\x04type\x18\x02 \x01(\t\x12\x14\n\x0cscheduler_id\x18\x03 \x01(\t\x12\x10\n\x08\x61rtifact\x18\x04 \x01(\x0c\x12\x17\n\x0f\x65valuation_json\x18\x05 \x01(\t\"\x1c\n\x0eModelIdRequest\x12\n\n\x02id\x18\x01 \x01(\t\"7\n\x11ListModelsRequest\x12\x14\n\x0cscheduler_id\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\";\n\x0fListModelsReply\x12(\n\x06models\x18\x01 \x03(\x0b\x32\x18.dragonfly2tpu.WireModel\"8\n\x12\x41\x63tiveModelRequest\x12\x14\n\x0cscheduler_id\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\"!\n\rArtifactReply\x12\x10\n\x08\x61rtifact\x18\x01 \x01(\x0c\"T\n\x18RegisterSchedulerRequest\x12\n\n\x02id\x18\x01 \x01(\t\x12\x12\n\ncluster_id\x18\x02 \x01(\t\x12\n\n\x02ip\x18\x03 \x01(\t\x12\x0c\n\x04port\x18\x04 \x01(\x05\"\'\n\x10KeepaliveRequest\x12\x13\n\x0binstance_id\x18\x01 \x01(\t\"\x1f\n\x0eKeepaliveReply\x12\r\n\x05known\x18\x01 \x01(\x08\"X\n\rWireScheduler\x12\n\n\x02id\x18\x01 \x01(\t\x12\x12\n\ncluster_id\x18\x02 \x01(\t\x12\n\n\x02ip\x18\x03 \x01(\t\x12\x0c\n\x04port\x18\x04 \x01(\x05\x12\r\n\x05state\x18\x05 \x01(\t\"G\n\x13ListSchedulersReply\x12\x30\n\nschedulers\x18\x01 \x03(\x0b\x32\x1c.dragonfly2tpu.WireScheduler\"S\n\x14\x43lusterSearchRequest\x12\n\n\x02ip\x18\x01 \x01(\t\x12\x10\n\x08hostname\x18\x02 \x01(\t\x12\x0b\n\x03idc\x18\x03 \x01(\t\x12\x10\n\x08location\x18\x04 \x01(\t\")\n\x12\x43lusterSearchReply\x12\x13\n\x0b\x63luster_ids\x18\x01 \x03(\t\"8\n\x12\x43\x65rtificateRequest\x12\x0f\n\x07\x63sr_pem\x18\x01 \x01(\x0c\x12\x11\n\tttl_hours\x18\x02 \x01(\r\"4\n\x10\x43\x65rtificateReply\x12\x10\n\x08\x63\x65rt_pem\x18\x01 \x01(\x0c\x12\x0e\n\x06\x63\x61_pem\x18\x02 \x01(\x0c\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'dragonfly_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _EMPTY._serialized_start=34
  _EMPTY._serialized_end=41
  _NETWORKINFO._serialized_start=43
  _NETWORKINFO._serialized_end=87
  _WIREHOST._serialized_start=90
  _WIREHOST._serialized_end=318
  _ANNOUNCEHOSTREQUEST._serialized_start=320
  _ANNOUNCEHOSTREQUEST._serialized_end=406
  _PROTOCOLINFO._serialized_start=408
  _PROTOCOLINFO._serialized_end=504
  _ANNOUNCEHOSTRESPONSE._serialized_start=506
  _ANNOUNCEHOSTRESPONSE._serialized_end=575
  _REGISTERPEERREQUEST._serialized_start=578
  _REGISTERPEERREQUEST._serialized_end=715
  _WIREPARENT._serialized_start=717
  _WIREPARENT._serialized_end=785
  _REGISTERPEERRESPONSE._serialized_start=788
  _REGISTERPEERRESPONSE._serialized_end=1046
  _SETTASKINFOREQUEST._serialized_start=1048
  _SETTASKINFOREQUEST._serialized_end=1156
  _TASKINFORESPONSE._serialized_start=1158
  _TASKINFORESPONSE._serialized_end=1247
  _REPORTPIECEFINISHEDREQUEST._serialized_start=1249
  _REPORTPIECEFINISHEDREQUEST._serialized_end=1362
  _REPORTPIECEFAILEDREQUEST._serialized_start=1364
  _REPORTPIECEFAILEDREQUEST._serialized_end=1426
  _SCHEDULERESPONSE._serialized_start=1428
  _SCHEDULERESPONSE._serialized_end=1519
  _PEERREQUEST._serialized_start=1521
  _PEERREQUEST._serialized_end=1551
  _DIRECTPIECEREQUEST._serialized_start=1553
  _DIRECTPIECEREQUEST._serialized_end=1608
  _HOSTREQUEST._serialized_start=1610
  _HOSTREQUEST._serialized_end=1640
  _SYNCPROBESSTARTRESPONSE._serialized_start=1642
  _SYNCPROBESSTARTRESPONSE._serialized_end=1709
  _PROBERESULT._serialized_start=1711
  _PROBERESULT._serialized_end=1754
  _SYNCPROBESFINISHEDREQUEST._serialized_start=1756
  _SYNCPROBESFINISHEDREQUEST._serialized_end=1845
  _ANNOUNCEPEERREQUEST._serialized_start=1848
  _ANNOUNCEPEERREQUEST._serialized_end=2447
  _ANNOUNCEPEERRESPONSE._serialized_start=2450
  _ANNOUNCEPEERRESPONSE._serialized_end=2744
  _TRAINCHUNK._serialized_start=2746
  _TRAINCHUNK._serialized_end=2865
  _TRAINREPLY._serialized_start=2867
  _TRAINREPLY._serialized_end=2892
  _RUNSTATUSREQUEST._serialized_start=2894
  _RUNSTATUSREQUEST._serialized_end=2925
  _RUNSTATUSREPLY._serialized_start=2928
  _RUNSTATUSREPLY._serialized_end=3070
  _WIREMODEL._serialized_start=3073
  _WIREMODEL._serialized_end=3203
  _CREATEMODELREQUEST._serialized_start=3205
  _CREATEMODELREQUEST._serialized_end=3318
  _MODELIDREQUEST._serialized_start=3320
  _MODELIDREQUEST._serialized_end=3348
  _LISTMODELSREQUEST._serialized_start=3350
  _LISTMODELSREQUEST._serialized_end=3405
  _LISTMODELSREPLY._serialized_start=3407
  _LISTMODELSREPLY._serialized_end=3466
  _ACTIVEMODELREQUEST._serialized_start=3468
  _ACTIVEMODELREQUEST._serialized_end=3524
  _ARTIFACTREPLY._serialized_start=3526
  _ARTIFACTREPLY._serialized_end=3559
  _REGISTERSCHEDULERREQUEST._serialized_start=3561
  _REGISTERSCHEDULERREQUEST._serialized_end=3645
  _KEEPALIVEREQUEST._serialized_start=3647
  _KEEPALIVEREQUEST._serialized_end=3686
  _KEEPALIVEREPLY._serialized_start=3688
  _KEEPALIVEREPLY._serialized_end=3719
  _WIRESCHEDULER._serialized_start=3721
  _WIRESCHEDULER._serialized_end=3809
  _LISTSCHEDULERSREPLY._serialized_start=3811
  _LISTSCHEDULERSREPLY._serialized_end=3882
  _CLUSTERSEARCHREQUEST._serialized_start=3884
  _CLUSTERSEARCHREQUEST._serialized_end=3967
  _CLUSTERSEARCHREPLY._serialized_start=3969
  _CLUSTERSEARCHREPLY._serialized_end=4010
  _CERTIFICATEREQUEST._serialized_start=4012
  _CERTIFICATEREQUEST._serialized_end=4068
  _CERTIFICATEREPLY._serialized_start=4070
  _CERTIFICATEREPLY._serialized_end=4122
# @@protoc_insertion_point(module_scope)
