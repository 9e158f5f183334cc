-- LF_I: inventory refresh (TPC-DS spec 5.3.11).
-- Reference behavior: nds/data_maintenance/LF_I.sql.
drop view if exists iv;
create temp view iv as
select d_date_sk inv_date_sk,
       i_item_sk inv_item_sk,
       w_warehouse_sk inv_warehouse_sk,
       invn_qty_on_hand inv_quantity_on_hand
from s_inventory
left outer join warehouse on (invn_warehouse_id = w_warehouse_id)
left outer join item on (invn_item_id = i_item_id and i_rec_end_date is null)
left outer join date_dim on (d_date = invn_date);
insert into inventory (select * from iv order by inv_date_sk);
